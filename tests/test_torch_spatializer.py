"""Kernel row 8, the full-table blend-apply-tail step: its plain twin
against the JAX package's Pallas kernel in interpret mode on the inputs of
tests/test_pallas.py, against the port's own unfused apply core, and the
wrappers' contracts on the CPU.

Tolerance: 1e-5 max-abs against the Pallas kernel and the apply cores, the
JAX test's own for these standard-normal spectra (tests/test_pallas.py:56);
the twin's forward form against the JAX live block step is held to 5e-7 in
tests/test_torch_stream.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.ops.filters import cmul as jcmul
from jefferson_tpu.ops.filters import distance_factors_split as jdistance
from jefferson_tpu.ops.filters import distance_phase_split
from jefferson_tpu.pallas.fused_spatializer import fused_apply as j_fused_apply
from jefferson_tpu.pallas.fused_spatializer import kernel_planes as j_kernel_planes
from jefferson_tpu_torch.convert import database_from_numpy, spectra_from_numpy
from jefferson_tpu_torch.engine.renderer import apply_filters_core, blend_channels
from jefferson_tpu_torch.kernels import fused_spatializer as tsp
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.ops.filters import cmul, distance_factors_split

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


def _case(config, name):
    """tests/test_pallas.py's inputs: (xr, xi, idx_old, w_old, idx_new,
    w_new, xfade, u_hi, u_lo, inv_frac) as NumPy arrays."""
    if name == "random":  # test_fused_apply_matches_core
        b, rng = 64, np.random.default_rng(0)
        xr = rng.standard_normal((b, 513)).astype(np.float32)
        xi = rng.standard_normal((b, 513)).astype(np.float32)
        idxo = rng.integers(0, 710, (b, 4)).astype(np.int32)
        wo = rng.random((b, 4)).astype(np.float32)
        idxn = rng.integers(0, 710, (b, 4)).astype(np.int32)
        wn = rng.random((b, 4)).astype(np.float32)
        xf = rng.random(b) > 0.4
        radii = rng.random(b).astype(np.float32)
    else:  # test_fused_apply_duplicate_brackets: one index 4x
        b, rng = 32, np.random.default_rng(1)
        xr = rng.standard_normal((b, 513)).astype(np.float32)
        xi = rng.standard_normal((b, 513)).astype(np.float32)
        idxo = idxn = np.tile(rng.integers(0, 710, (b, 1)), (1, 4)).astype(np.int32)
        wo = wn = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), (b, 1))
        xf = np.zeros(b, bool)
        radii = np.full(b, 0.2, np.float32)
    return (xr, xi, idxo, wo, idxn, wn, xf,
            *distance_phase_split(config.fsvs, radii, config.num_bins))


def _xd_torch(xr, xi, uh, ul, fr, bins):
    t = torch.from_numpy
    return cmul(t(xr), t(xi), *distance_factors_split(t(uh), t(ul), t(fr), bins))


def _twin(tdb, xdr, xdi, idxo, wo, idxn, wn, xf, bins, fpb):
    t = torch.from_numpy
    before = dict(tfs.launches)
    got = tsp.fused_apply(tsp.kernel_planes(tdb, "cpu"), xdr, xdi, t(idxo), t(wo), t(idxn), t(wn),
                          t(xf.astype(np.float32)[:, None]), bins=bins, fpb=fpb)
    assert tfs.launches == before  # CPU operands run the twin, never a kernel
    return got


@pytest.mark.parametrize("name", ["random", "duplicate_brackets"])
def test_twin_matches_the_pallas_kernel(db, tdb, config, name):
    xr, xi, idxo, wo, idxn, wn, xf, uh, ul, fr = _case(config, name)
    bins, fpb = config.num_bins, config.frames_per_buffer
    dr, di = jdistance(jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(fr), bins)
    jxdr, jxdi = jcmul(jnp.asarray(xr), jnp.asarray(xi), dr, di)
    want = np.asarray(j_fused_apply(
        j_kernel_planes(db), jxdr, jxdi, jnp.asarray(np.concatenate([idxo, idxn], 1)),
        jnp.asarray(np.concatenate([wo, wn], 1)), jnp.asarray(xf), config, tb=32, interpret=True))
    # the same XD planes on both sides, so only row 8 is compared
    xdr, xdi = torch.from_numpy(np.array(jxdr)), torch.from_numpy(np.array(jxdi))
    got = _twin(tdb, xdr, xdi, idxo, wo, idxn, wn, xf, bins, fpb)
    y = got.numpy().reshape(-1, 2, fpb).transpose(0, 2, 1)
    d = float(np.abs(y - want).max())
    print(f"row 8 twin vs Pallas interpret ({name}): max|diff| = {d:.3e} (limit {TOL:.0e})")
    assert want.shape == y.shape == (len(xf), fpb, 2)
    assert d < TOL
    # the JAX-signature adapter gives the same values in the JAX layout
    packed = tsp.fused_apply_packed(
        tsp.kernel_planes(tdb, "cpu"), xdr, xdi, torch.from_numpy(np.concatenate([idxo, idxn], 1)),
        torch.from_numpy(np.concatenate([wo, wn], 1)), torch.from_numpy(xf), bins=bins, fpb=fpb)
    assert torch.equal(packed, torch.from_numpy(y))


@pytest.mark.parametrize("name", ["random", "duplicate_brackets"])
def test_twin_matches_the_apply_core(tdb, config, name):
    """Row 8 against the port's unfused chain on the same forward planes:
    the distance folded in first, the blends, the tails, the crossfade."""
    xr, xi, idxo, wo, idxn, wn, xf, uh, ul, fr = _case(config, name)
    bins, fpb = config.num_bins, config.frames_per_buffer
    t = torch.from_numpy
    spectra = spectra_from_numpy(tdb.spectra, "cpu")
    want = apply_filters_core(
        t(xr), t(xi), blend_channels(spectra, t(idxo), t(wo)),
        blend_channels(spectra, t(idxn), t(wn)), t(xf), t(uh), t(ul), t(fr),
        config=tdb.config, with_xfade=True).numpy()
    got = _twin(tdb, *_xd_torch(xr, xi, uh, ul, fr, bins), idxo, wo, idxn, wn, xf, bins, fpb)
    d = float(np.abs(got.numpy().reshape(-1, 2, fpb).transpose(0, 2, 1) - want).max())
    print(f"row 8 twin vs apply_filters_core ({name}): max|diff| = {d:.3e} (limit {TOL:.0e})")
    assert d < TOL


def test_kernel_planes_is_the_jax_planes_side_by_side(db, tdb):
    got = tsp.kernel_planes(tdb, "cpu").numpy()
    want = np.concatenate([np.asarray(p) for p in j_kernel_planes(db)], axis=1)
    assert got.shape == (710, 4 * 513)
    np.testing.assert_array_equal(got, want)


def test_ids_outside_the_table_add_nothing(tdb, config):
    """An id outside the table matches no one-hot column on the TPU: the
    twin gives it weight 0, whatever its weight says."""
    xr, xi, idxo, wo, idxn, wn, xf, uh, ul, fr = _case(config, "random")
    bins, fpb = config.num_bins, config.frames_per_buffer
    xd = _xd_torch(xr, xi, uh, ul, fr, bins)
    bad_o, bad_n = idxo.copy(), idxn.copy()
    bad_o[3, 1], bad_o[10, 0], bad_n[5, 2], bad_n[63, 3] = 710, -1, 900, -7
    got = _twin(tdb, *xd, bad_o, wo, bad_n, wn, xf, bins, fpb)
    wo0, wn0 = wo.copy(), wn.copy()
    wo0[3, 1] = wo0[10, 0] = wn0[5, 2] = wn0[63, 3] = 0.0
    fix = lambda a: np.clip(a, 0, 709)
    want = _twin(tdb, *xd, fix(bad_o), wo0, fix(bad_n), wn0, xf, bins, fpb)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [1, 7, 33])
def test_any_row_count_and_the_no_crossfade_use(tdb, config, rows):
    """Any B >= 1 (the TPU form needs B % tb == 0); with the new brackets on
    both sides and xf = 0 the output is the crossfade form's on a held block
    bit for bit, whatever the old brackets were."""
    xr, xi, idxo, wo, idxn, wn, xf, uh, ul, fr = (a[:rows] for a in _case(config, "random"))
    bins, fpb = config.num_bins, config.frames_per_buffer
    xd = _xd_torch(xr, xi, uh, ul, fr, bins)
    held = np.zeros(rows, bool)
    xf_form = _twin(tdb, *xd, idxo, wo, idxn, wn, held, bins, fpb)
    noxf_form = _twin(tdb, *xd, idxn, wn, idxn, wn, held, bins, fpb)
    assert xf_form.shape == (rows, 2 * fpb)
    assert torch.equal(xf_form, noxf_form)
    assert not torch.equal(xf_form, _twin(tdb, *xd, idxo, wo, idxn, wn, ~held, bins, fpb))


def test_forward_form_is_the_forward_then_row_8(tdb, config):
    """fused_forward_apply on one stream = the sliding forward times the
    distance planes, then row 8; the XD it computed lands in ``scratch``."""
    rng = np.random.default_rng(5)
    rows, bins, fpb = 9, config.num_bins, config.frames_per_buffer
    t = torch.from_numpy
    stream = t((rng.standard_normal(config.history_len + rows * fpb) * 0.2).astype(np.float32))
    uh, ul, fr = (t(a[:, None]) for a in distance_phase_split(
        config.fsvs, rng.uniform(0.1, 0.5, rows).astype(np.float32), bins))
    idx = t(rng.integers(0, 710, (rows, 4)).astype(np.int32))
    w = t(rng.random((rows, 4)).astype(np.float32))
    idx2, w2 = idx.flip(0).contiguous(), w.flip(0).contiguous()
    xf = t((np.arange(rows) % 3 == 0).astype(np.float32)[:, None])
    table = tsp.kernel_planes(tdb, "cpu")
    kw = dict(pad_len=config.pad_len, bins=bins, fpb=fpb)
    scratch = (torch.empty(rows, bins), torch.empty(rows, bins))
    got = tsp.fused_forward_apply(table, stream, uh, ul, fr, idx, w, idx2, w2, xf,
                                  scratch=scratch, **kw)
    xdr, xdi = tfs._forward_reference(stream[None], rows, uh, ul, fr, None, None, **kw)
    assert torch.equal(scratch[0], xdr) and torch.equal(scratch[1], xdi)
    want = tsp.fused_apply(table, xdr, xdi, idx, w, idx2, w2, xf, bins=bins, fpb=fpb)
    assert torch.equal(got, want)
    assert torch.equal(got, tsp.fused_forward_apply_reference(
        table, stream, uh, ul, fr, idx, w, idx2, w2, xf, **kw))
    with pytest.raises(ValueError, match="do not hold"):
        tsp.fused_forward_apply(table, stream[:-1], uh, ul, fr, idx, w, idx2, w2, xf, **kw)


def test_wrappers_refuse_mixed_and_unknown_devices(tdb, config):
    xr, xi, idxo, wo, idxn, wn, xf, uh, ul, fr = _case(config, "random")
    bins, fpb = config.num_bins, config.frames_per_buffer
    t = torch.from_numpy
    xdr, xdi = _xd_torch(xr, xi, uh, ul, fr, bins)
    args = [tsp.kernel_planes(tdb, "cpu"), xdr, xdi, t(idxo), t(wo), t(idxn), t(wn),
            t(xf.astype(np.float32)[:, None])]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device"):
        tsp.fused_apply(*meta, bins=bins, fpb=fpb)
    with pytest.raises(ValueError, match="one device"):
        tsp.fused_apply(*meta[:1], *args[1:], bins=bins, fpb=fpb)


@pytest.mark.parametrize("rows", [1, 7, 32])
@pytest.mark.parametrize("name", ["random", "duplicate_brackets"])
def test_the_no_crossfade_use_is_the_new_side_alone(tdb, config, rows, name):
    """With xf = 0 the output is the new side's tails alone, bit for bit,
    whatever the old brackets are: the held block's contract."""
    xr, xi, idxo, wo, idxn, wn, _, uh, ul, fr = (a[:rows] for a in _case(config, name))
    bins, fpb = config.num_bins, config.frames_per_buffer
    t = torch.from_numpy
    xd = _xd_torch(xr, xi, uh, ul, fr, bins)
    table = tsp.kernel_planes(tdb, "cpu")
    g_new = tfs.blend_cat(table, *tfs._in_table(t(idxn), t(wn), table.shape[0]))
    new_side = tfs._tails_reference(*xd, None, g_new, None, pad_len=2 * (bins - 1), bins=bins,
                                    fpb=fpb)
    before = dict(tfs.launches)
    off = np.zeros(rows, bool)
    for old in ((idxo, wo), (idxn, wn)):
        got = _twin(tdb, *xd, *old, idxn, wn, off, bins, fpb)
        assert got.shape == (rows, 2 * fpb)
        assert torch.equal(got, new_side)
    assert tfs.launches == before


def test_forward_form_without_crossfade_is_the_forward_then_the_new_side(tdb, config):
    rng = np.random.default_rng(6)
    rows, bins, fpb = 5, config.num_bins, config.frames_per_buffer
    t = torch.from_numpy
    stream = t((rng.standard_normal(config.history_len + rows * fpb) * 0.2).astype(np.float32))
    uh, ul, fr = (t(a[:, None]) for a in distance_phase_split(
        config.fsvs, rng.uniform(0.1, 0.5, rows).astype(np.float32), bins))
    idx = t(rng.integers(0, 710, (rows, 4)).astype(np.int32))
    w = t(rng.random((rows, 4)).astype(np.float32))
    table = tsp.kernel_planes(tdb, "cpu")
    kw = dict(pad_len=config.pad_len, bins=bins, fpb=fpb)
    got = tsp.fused_forward_apply(table, stream, uh, ul, fr, idx, w, idx, w,
                                  torch.zeros((rows, 1)), **kw)
    xdr, xdi = tfs._forward_reference(stream[None], rows, uh, ul, fr, None, None, **kw)
    g_new = tfs.blend_cat(table, idx, w)
    assert torch.equal(got, tfs._tails_reference(xdr, xdi, None, g_new, None, **kw))


def test_the_card_form_is_chosen_by_rows():
    """The live step's one row takes the cluster form, render_scan's chunks
    launch B's split form; SMALL_ROWS is the last row count on the cluster
    form."""
    from jefferson_tpu_torch.engine.stream import SCAN_CHUNK

    assert tsp.pick_form(1) == tsp.CLUSTER
    assert tsp.pick_form(tsp.SMALL_ROWS) == tsp.CLUSTER
    assert tsp.MANY_ROWS_FORM == tsp.SPLIT
    assert tsp.pick_form(tsp.SMALL_ROWS + 1) == tsp.SPLIT
    assert tsp.pick_form(SCAN_CHUNK) == tsp.SPLIT
    assert tsp.pick_form(12556) == tsp.SPLIT


def test_reset_sets_row_8s_form_counts_to_0():
    """Row 8's launches by form: the three forms, all set to 0 with the
    launch counts."""
    assert set(tfs.spatializer_forms) == {tsp.CLUSTER, tsp.LAUNCH_B, tsp.SPLIT}
    tfs.spatializer_forms[tsp.CLUSTER] += 2
    tfs.reset_launches()
    assert set(tfs.spatializer_forms.values()) == {0}


def test_the_card_entry_refuses_an_unknown_form():
    """The wrapper's private seam takes only the three forms, before it
    reads any operand."""
    with pytest.raises(ValueError, match="want 'cluster', 'launch_b' or 'split'"):
        tsp._cuda(torch.device("cpu"), 1, None, None, None, None, None, None, pad_len=1024,
                  bins=513, fpb=128, form="held")
