"""The batched scene steps (kernel rows 2, 6 and 7): each plain twin against
the JAX package's Pallas kernel in interpret mode, in every form, the
no-crossfade contracts, ids outside a group's table, and the wrappers'
operand checks.

Tolerance: 5e-7 max-abs on the (rows, 256) outputs, the JAX package's own
fused-vs-unfused gate (tests/test_batch_parallel.py:834).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.pallas import fused_apply as jfa
from jefferson_tpu.pallas import fused_step as jfs
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.kernels import fused_apply as tfa
from jefferson_tpu_torch.kernels import fused_step as tfs

torch.set_num_threads(1)

TOL = 5e-7


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


def _j(a):
    return None if a is None else jnp.asarray(a.numpy())


def _twin(fn):
    module = tfa if fn is tfa.fused_apply_xfade else tfs
    return getattr(module, fn.__name__ + "_reference")


def _run(fn, args, kw):
    """The wrapper on CPU operands: it runs the twin, never a kernel."""
    before = dict(tfs.launches)
    got = fn(*args, **kw)
    assert tfs.launches == before
    assert torch.equal(got, _twin(fn)(*args, **kw))
    return got.numpy()


def _pallas(fn, args, kw, tb):
    jkw = {**kw, "tb": tb}
    if "dsel" in jkw:
        jkw["dsel"] = _j(jkw["dsel"])
    module = jfa if fn is tfa.fused_apply_xfade else jfs
    return np.asarray(getattr(module, fn.__name__)(*map(_j, args), **jkw))


@pytest.fixture
def small_tables(monkeypatch):
    """A small scene's filters overflow a shrunken compact-table gate, so
    the dispatch plans per-source-group tables (the JAX tests' shrink,
    tests/test_batch_parallel.py:460)."""
    monkeypatch.setattr(tfs, "MAX_ONEHOT_U", 32)


# the two distance forms: each block at its own radius, or |coordinates| = 1
DISTANCE = {"per_row": {"radius_step": 0.01}, "compact": {"unit_radius": True}}


@pytest.mark.parametrize("dist", list(DISTANCE))
@pytest.mark.parametrize("tiles", [None, (8, 2)])
def test_grouped_onehot_twin_matches_pallas(tdb, small_tables, dist, tiles):
    """Row 2: 4 sources x 8 blocks in groups of 2 sources; the dispatch's
    tile (one tile per group) and two 8-row tiles per group."""
    fn, args, kw = bench.scene_step(tdb, "grouped", 4, 8, "cpu", xf_every=3, seed=1,
                                    **DISTANCE[dist])
    assert ("n_dist" in kw) == (dist == "compact")
    assert (kw["tb"], kw["group_tiles"]) == (16, 1) and args[4].shape[0] == 2 * 32
    if tiles is not None:
        kw["tb"], kw["group_tiles"] = tiles
    got = _run(fn, args, kw)
    assert got.shape == (32, 256)
    assert np.abs(got - _pallas(fn, args, kw, kw["tb"])).max() <= TOL


def test_grouped_ids_outside_a_groups_table_match_pallas(tdb, small_tables):
    """An id outside its group's rows (another group's, or past the stacked
    table) adds nothing, as on the TPU."""
    fn, args, kw = bench.scene_step(tdb, "grouped", 4, 8, "cpu", seed=2)
    args = list(args)
    ridx, last = args[5].clone(), args[7].clone()
    ridx[1, 2], ridx[17, 0], ridx[30, 3], last[3, 1], last[0, 0] = 32, -1, 70, 33, -5
    args[5], args[7] = ridx, last
    got = _run(fn, args, kw)
    assert np.abs(got - _pallas(fn, args, kw, kw["tb"])).max() <= TOL


@pytest.mark.parametrize("form", ["gather", "gather_noxf"])
@pytest.mark.parametrize("dist", list(DISTANCE))
def test_batched_gather_twin_matches_pallas(tdb, form, dist):
    """Row 6 in both forms, per-row and compact distance."""
    fn, args, kw = bench.scene_step(tdb, form, 4, 8, "cpu", xf_every=5, seed=3, **DISTANCE[dist])
    assert ("n_dist" in kw) == (dist == "compact")
    got = _run(fn, args, kw)
    assert got.shape == (32, 256)
    assert np.abs(got - _pallas(fn, args, kw, tb=16)).max() <= TOL


@pytest.mark.parametrize("form", ["apply", "apply_noxf"])
@pytest.mark.parametrize("s,nb,tb", [(4, 8, 16), (1, 24, 8)])
def test_apply_only_twin_matches_pallas(tdb, form, s, nb, tb):
    """Row 7 in both forms: segments shorter than the TPU tile (several
    sources per tile) and longer (several tiles per source)."""
    fn, args, kw = bench.scene_step(tdb, form, s, nb, "cpu", xf_every=3, seed=4)
    got = _run(fn, args, kw)
    assert got.shape == (s * nb, 256)
    assert np.abs(got - _pallas(fn, args, kw, tb=tb)).max() <= TOL


@pytest.mark.parametrize("form", ["gather", "apply"])
def test_forms_bit_equal_without_crossfade(tdb, form):
    """On a crossfade-free chunk the no-crossfade form gives the crossfade
    form's bits (out = y_old*0 + y_new*1), the JAX package's contract
    (tests/test_noxfade.py:44-81,114-149)."""
    fn, args, kw = bench.scene_step(tdb, form, 3, 8, "cpu", trajectory="still", seed=5)
    _, args_n, kw_n = bench.scene_step(tdb, form + "_noxf", 3, 8, "cpu", trajectory="still", seed=5)
    xf = args[6] if form == "gather" else args[4]
    assert not xf.any()
    assert torch.equal(fn(*args, **kw), fn(*args_n, **kw_n))


def test_scene_wrappers_check_operands(tdb, small_tables):
    fn, args, kw = bench.scene_step(tdb, "grouped", 4, 8, "cpu", seed=6)
    with pytest.raises(ValueError, match="do not split into groups"):
        fn(*args, **{**kw, "group_tiles": 3})
    with pytest.raises(ValueError, match="whole sources"):
        fn(*args, **{**kw, "tb": 4, "group_tiles": 4})
    with pytest.raises(ValueError, match="does not split into 2 groups"):
        fn(*args[:4], args[4][:-1], *args[5:], **kw)

    fn, args, kw = bench.scene_step(tdb, "gather", 2, 8, "cpu", seed=6)
    with pytest.raises(ValueError, match="needs g_last and xf"):
        fn(*args[:5], None, args[6], **kw)
    with pytest.raises(ValueError, match="history"):
        fn(args[0][:, 1:], *args[1:], **kw)

    fn, args, kw = bench.scene_step(tdb, "apply", 2, 8, "cpu", seed=6)
    with pytest.raises(ValueError, match="segments of 5"):
        fn(*args, **{**kw, "seg": 5})
    with pytest.raises(ValueError, match="needs g_last and xf"):
        fn(*args[:3], None, *args[4:], **kw)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="one device"):
        fn(meta[0], *args[1:], **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(*meta, **kw)

    with pytest.raises(ValueError, match="not in"):
        bench.scene_step(tdb, "onehot", 2, 8, "cpu")
    with pytest.raises(ValueError, match="no grouped one-hot plan"):
        bench.scene_step(tdb, "grouped", 2, 8, "cpu", trajectory="still")


@pytest.mark.parametrize("kernel,want", [
    ("fused_step_onehot_xfade", 1.3974e6), ("fused_step_xfade", 1.3646e6),
    ("fused_step_xfade/no_xfade", 0.8331e6), ("fused_apply_xfade", 1.0629e6),
    ("fused_spatializer_apply", 1.0958e6),
])
def test_step_flops_per_row(kernel, want):
    """The bound's operation count per row at 16 x 256 (forward about 0.30
    M, crossfade tails 1.06 M, one-hot blend 33 k)."""
    assert bench.step_flops(kernel, 16, 256) / 4096 == pytest.approx(want, rel=1e-3)
    ms, by = bench.bound_ms(bench.step_flops(kernel, 16, 256), 40e6)
    assert by == "operations" and ms == pytest.approx(want * 4096 / 67e9, rel=1e-3)
    assert bench.bound_ms(1e6, 10**9)[1] == "bytes"


# ---- launch B's two forms on the card: the choice and the private seam ---------

@pytest.mark.parametrize("name", [tfs.GROUPED, "fused_step_xfade", "fused_step_xfade/no_xfade"])
def test_rows_6_and_2_take_the_split_form_by_rows(name):
    """The scene path's steps take the split form from SPLIT_FROM rows on,
    its 16 x 256 = 4,096 rows included."""
    assert tfs.pick_form(name, tfs.SPLIT_FROM) == tfs.SPLIT
    assert tfs.pick_form(name, 4096) == tfs.SPLIT == tfs.pick_form(name, 16384)
    if tfs.SPLIT_FROM > 1:
        assert tfs.pick_form(name, tfs.SPLIT_FROM - 1) == tfs.LAUNCH_B


def test_row_1_takes_launch_b_at_every_row_count():
    """Row 1 sums one chain over K, so never the split form: launch B, in
    its one-CTA form below STAGED_FROM rows and its staged form from there
    on (the same bits)."""
    for rows in (1, 4096, 16384):
        want = tfs.STAGED if rows >= tfs.STAGED_FROM else tfs.LAUNCH_B
        assert tfs.pick_form("fused_step_onehot_xfade", rows) == want != tfs.SPLIT


def test_the_private_seam_refuses_an_unknown_form(tdb):
    fn, args, kw = bench.scene_step(tdb, "gather", 2, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="want 'launch_b' or 'split'"):
        tfs._cuda(fn, *args, form="cluster", **kw)


def test_the_private_seam_names_the_form_for_its_call_only(tdb):
    """Inside ``_cuda`` a launch takes the named form, row 1 refuses the
    split one; after it the wrappers pick again.  On the CPU the twin runs."""
    name = "fused_step_xfade"
    assert tfs._cuda(lambda: tfs._form(name, 4096), form=tfs.LAUNCH_B) == tfs.LAUNCH_B
    assert tfs._form(name, 4096) == tfs.pick_form(name, 4096)
    with pytest.raises(ValueError, match="launch B only"):
        tfs._cuda(lambda: tfs._form("fused_step_onehot_xfade", 64), form=tfs.SPLIT)
    assert tfs._named_form.get() is None
    fn, args, kw = bench.scene_step(tdb, "gather", 2, 8, torch.device("cpu"))
    assert torch.equal(tfs._cuda(fn, *args, form=tfs.SPLIT, **kw), fn(*args, **kw))


def test_reset_sets_the_split_counts_to_0():
    tfs.split_launches[tfs.GROUPED] += 3
    tfs.reset_launches()
    assert set(tfs.split_launches.values()) == {0}
    assert "fused_step_onehot_xfade" not in tfs.split_launches

