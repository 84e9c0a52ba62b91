"""The CUDA step on a card: against its plain twin, inside the renderer, and
its operand checks.  Every test needs a CUDA device and skips without one.

This file imports no jax, so a machine without jax runs it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import time

import numpy as np
import pytest
import torch

from jefferson_tpu_torch import bench
from jefferson_tpu_torch.config import DEFAULT_CONFIG
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.engine.stream import StreamingSpatializer, render_scan
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.kernels import assoc_probe as tap
from jefferson_tpu_torch.kernels import build as tbuild
from jefferson_tpu_torch.kernels import dma_blend as tdb
from jefferson_tpu_torch.kernels import fused_apply as tfa
from jefferson_tpu_torch.kernels import fused_spatializer as tsp
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.oracle.reference import render_oracle
from jefferson_tpu_torch.scripts import apply_assoc_probe as sap
from jefferson_tpu_torch.scripts import bench_blend_variants as sbb

pytestmark = pytest.mark.cuda

TOL = 5e-7  # kernel vs twin: fp32 DFT sums in another order
MM_REL = 2e-6  # rows 10-11 vs twin, of the output peak: fp32 sums in other orders


def _one_step_a_chunk_and_the_pre_blends(dispatch):
    """A render's launches: one step a chunk, and row 12 (blend_rows) at
    least once on each chunk whose step takes pre-blended rows (rows 5-7)."""
    steps = sum(v for k, v in tfs.launches.items() if k != "dma_blend")
    pre_blended = sum(1 for arm, _, _ in dispatch if arm in ("dedup_fused", "gather_fused"))
    assert steps == len(dispatch)
    assert tfs.launches["dma_blend"] >= pre_blended
    assert bool(tfs.launches["dma_blend"]) == bool(pre_blended)


@pytest.fixture(scope="module")
def card_db():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return synthetic_database(DEFAULT_CONFIG)


def _operands(db, radius_step, s=4, nb=16):
    wl = bench.build_workload(db, s, nb, torch.device("cuda", 0), radius_step=radius_step)
    return bench.step_operands(wl, DEFAULT_CONFIG)


@pytest.mark.parametrize("radius_step", [0.0, 0.05])
def test_kernel_matches_twin(card_db, radius_step):
    args, kw = _operands(card_db, radius_step)
    before = tfs.launches["fused_step_onehot_xfade"]
    got = tfs.fused_step_onehot_xfade(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.launches["fused_step_onehot_xfade"] == before + 1
    want = tfs.fused_step_onehot_xfade_reference(*args, **kw)
    assert got.shape == want.shape == (64, 256)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("s,nb,radius_step", [
    (1, 1, 0.0), (3, 5, 0.05), (2, 33, 0.0), (1, 256, 0.05), (7, 40, 0.0),
])
def test_kernel_matches_twin_at_ragged_shapes(card_db, s, nb, radius_step):
    """Block counts that are not a multiple of the kernels' 32-row tiles."""
    args, kw = _operands(card_db, radius_step, s, nb)
    got = tfs.fused_step_onehot_xfade(*args, **kw)
    want = tfs.fused_step_onehot_xfade_reference(*args, **kw)
    assert got.shape == (s * nb, 256)
    assert float((got - want).abs().max()) <= TOL


def test_kernel_matches_twin_on_ids_outside_the_table(card_db):
    args, kw = _operands(card_db, 0.0)
    args = list(args)
    u = args[4].shape[0]
    args[5] = args[5].clone()
    args[5][3, 1], args[5][17, 0] = u + 2, -4
    kw = {**kw, "dsel": kw["dsel"].clone()}
    kw["dsel"][9, 0] = 7
    got = tfs.fused_step_onehot_xfade(*args, **kw)
    want = tfs.fused_step_onehot_xfade_reference(*args, **kw)
    assert float((got - want).abs().max()) <= TOL


def test_render_on_the_card_matches_the_cpu_twin(card_db):
    signals, positions = bench.moving_scene(3, 37, DEFAULT_CONFIG)
    before = tfs.launches["fused_step_onehot_xfade"]
    got = BatchRenderer(card_db, device="cuda", chunk_blocks=16).render(signals, positions)
    assert tfs.launches["fused_step_onehot_xfade"] == before + 3
    want = BatchRenderer(card_db, device="cpu", chunk_blocks=16).render(signals, positions)
    assert np.abs(got - want).max() <= TOL


def test_kernel_refuses_operands_it_does_not_take(card_db):
    args, kw = _operands(card_db, 0.0)
    bad = list(args)
    bad[6] = args[6].double()
    with pytest.raises(ValueError, match="w: want contiguous"):
        tfs.fused_step_onehot_xfade(*bad, **kw)
    bad = list(args)
    bad[5] = args[5].t().contiguous().t()
    with pytest.raises(ValueError, match="ridx: want contiguous"):
        tfs.fused_step_onehot_xfade(*bad, **kw)
    with pytest.raises(ValueError, match="bins 257 is not pad_len/2 \\+ 1"):
        tfs.fused_step_onehot_xfade(*args, **{**kw, "bins": 257})


# ---- the single-stream steps (kernel rows 3, 4 and 5) -----------------------

_GROUPING = {8: (8, 1), 264: (8, 3), 2048: (256, 2)}  # B -> (tb, group_tiles)


def _stream(db, form, b, **kw):
    tb, gt = _GROUPING[b]
    return bench.stream_step(db, form, b, torch.device("cuda", 0), tb=tb, group_tiles=gt, **kw)


@pytest.mark.parametrize("b", [8, 264, 2048])
@pytest.mark.parametrize("form", bench.STREAM_FORMS)
@pytest.mark.parametrize("radius_step", [0.0, 0.01])
def test_stream_kernels_match_twins(card_db, form, b, radius_step):
    fn, args, kw = _stream(card_db, form, b, radius_step=radius_step, xf_every=5)
    name = tfs.NO_XFADE if form == "gather_noxf" else fn.__name__
    before = tfs.launches[name]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.launches[name] == before + 1
    want = getattr(tfs, fn.__name__ + "_reference")(*args, **kw)
    assert got.shape == want.shape == (b, 256)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("form", ["onehot", "grouped"])
def test_stream_kernels_on_ids_outside_the_table(card_db, form):
    fn, args, kw = _stream(card_db, form, 264, trajectory="orbit")
    args = list(args)
    u = kw.get("u_pad", args[4].shape[0])
    args[5] = args[5].clone()
    args[7] = args[7].clone()
    args[5][3, 1], args[5][100, 0], args[7][-1, 2], args[7][0, 3] = u + 2, -4, u, -1
    kw = {**kw, "dsel": kw["dsel"].clone()}
    kw["dsel"][9, 0] = 7
    got = fn(*args, **kw)
    want = getattr(tfs, fn.__name__ + "_reference")(*args, **kw)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("b", [8, 264, 2048])
def test_gather_forms_bit_equal_without_crossfade(card_db, b):
    fn, args, kw = _stream(card_db, "gather", b, trajectory="hold", seed=4)
    _, args_n, kw_n = _stream(card_db, "gather_noxf", b, trajectory="hold", seed=4)
    assert not bool(args[-1].any())
    assert torch.equal(fn(*args, **kw), fn(*args_n, **kw_n))


def test_stream_kernels_refuse_operands_they_do_not_take(card_db):
    fn, args, kw = _stream(card_db, "gather", 264)
    bad = list(args)
    bad[4] = args[4][:, :2000]
    with pytest.raises(ValueError, match="g_old: want contiguous"):
        fn(*bad, **kw)
    fn, args, kw = _stream(card_db, "grouped", 264)
    bad = list(args)
    bad[7] = args[7][:-1]
    with pytest.raises(ValueError, match="boundary ids: want"):
        fn(*bad, **kw)
    fn, args, kw = _stream(card_db, "onehot", 264)
    with pytest.raises(ValueError, match="xf: want"):
        fn(*args[:-1], args[-1].double(), **kw)


@pytest.mark.parametrize("case", ["sparse", "hold", "mover", "grouped", "gather"])
def test_renderer_on_the_card_matches_the_cpu_twins(card_db, case, monkeypatch):
    from jefferson_tpu_torch.engine.renderer import Renderer

    b, cb, opts = 600, 256, {}
    if case in ("sparse", "hold"):
        pos = bench.sweep_positions(3.0, 5.0)[:b]
        opts = {"sparse_xfade": case == "sparse"}
    elif case == "grouped":
        b, cb = 1024, 1024
        monkeypatch.setattr(tfs, "MAX_ONEHOT_U", 128)
        pos = bench.mover_positions(b)
    else:
        pos = bench.orbit(0, b)
        if case == "gather":
            monkeypatch.setattr(tfs, "MAX_ONEHOT_U", 4)
    sig = np.random.default_rng(0).standard_normal(b * 128).astype(np.float32) * 0.2
    card = Renderer(card_db, device="cuda", chunk_blocks=cb, **opts)
    tfs.reset_launches()
    got = card.render(sig, pos)
    _one_step_a_chunk_and_the_pre_blends(card.dispatch)
    cpu = Renderer(card_db, device="cpu", chunk_blocks=cb, **opts)
    want = cpu.render(sig, pos)
    assert card.dispatch == cpu.dispatch
    assert np.abs(got - want).max() <= TOL


def test_unfused_renderer_on_the_card_takes_the_blocked_tail(card_db):
    """fused=False on the card: no kernel, the tail IDFT summed by 128-bin
    blocks (ops/fft.irfft_tail) as on the CPU; within TOL of the CPU's
    render and 1e-6 of the oracle."""
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.ops import fft as tops

    pos = bench.sweep_positions(3.0, 0.0)[:400]
    sig = np.random.default_rng(0).standard_normal(400 * 128).astype(np.float32) * 0.2
    tfs.reset_launches()
    got = Renderer(card_db, device="cuda", fused=False).render(sig, pos)
    assert sum(tfs.launches.values()) == 0
    want = Renderer(card_db, device="cpu", fused=False).render(sig, pos)
    assert np.abs(got - want).max() <= TOL
    oracle = render_oracle(sig, card_db, [tuple(p) for p in pos], card_db.config)
    assert np.abs(got - oracle).max() <= 1e-6
    rng = np.random.default_rng(4)
    re, im = (torch.from_numpy(rng.standard_normal((2, 64, 513)).astype(np.float32)).cuda()
              for _ in range(2))
    got = tops.irfft_tail(re, im, 1024, 128)
    want = tops.irfft_tail_split(re, im, 1024, 128)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# ---- the batched scene steps (kernel rows 2, 6 and 7) -----------------------

# rows -> (sources, blocks per source) for rows 2 and 6; row 7 takes the
# same rows as segments
_SCENE_SHAPES = {8: (1, 8), 264: (4, 66), 4096: (16, 256)}
# the two distance forms: each block at its own radius, or |coordinates| = 1
_DISTANCE = {"per_row": {"radius_step": 0.01}, "compact": {"unit_radius": True}}


def _scene(db, form, rows, **kw):
    s, nb = _SCENE_SHAPES[rows]
    return bench.scene_step(db, form, s, nb, torch.device("cuda", 0), **kw)


def _twin(fn):
    return getattr(tfa if fn is tfa.fused_apply_xfade else tfs, fn.__name__ + "_reference")


@pytest.mark.parametrize("rows", [8, 264, 4096])
@pytest.mark.parametrize("form", bench.SCENE_FORMS)
@pytest.mark.parametrize("dist", list(_DISTANCE))
def test_scene_kernels_match_twins(card_db, form, rows, dist):
    # at 4,096 rows the dispatch's own group plan; below, one source per group
    groups = {"group_sources": 1} if form == "grouped" and rows < 4096 else {}
    fn, args, kw = _scene(card_db, form, rows, xf_every=5, **_DISTANCE[dist], **groups)
    assert ("n_dist" in kw) == (dist == "compact" and not form.startswith("apply"))
    name = {"grouped": tfs.GROUPED, "gather": "fused_step_xfade",
            "gather_noxf": "fused_step_xfade/no_xfade", "apply": "fused_apply_xfade",
            "apply_noxf": tfa.NO_XFADE}[form]
    before = tfs.launches[name]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.launches[name] == before + 1
    want = _twin(fn)(*args, **kw)
    assert got.shape == want.shape == (rows, 256)
    assert float((got - want).abs().max()) <= TOL


def test_grouped_kernel_on_ids_outside_a_groups_table(card_db):
    fn, args, kw = _scene(card_db, "grouped", 264, unit_radius=True, group_sources=1)
    args = list(args)
    u = args[4].shape[0] // 4  # four groups of one source
    args[5], args[7] = args[5].clone(), args[7].clone()
    args[5][3, 1], args[5][100, 0], args[7][-1, 2], args[7][0, 3] = u, -4, 3 * u, -1
    kw = {**kw, "dsel": kw["dsel"].clone()}
    kw["dsel"][9, 0] = 7
    got = fn(*args, **kw)
    want = _twin(fn)(*args, **kw)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("rows", [8, 264, 4096])
@pytest.mark.parametrize("form", ["gather", "apply"])
def test_scene_forms_bit_equal_without_crossfade(card_db, form, rows):
    fn, args, kw = _scene(card_db, form, rows, trajectory="still", seed=4)
    _, args_n, kw_n = _scene(card_db, form + "_noxf", rows, trajectory="still", seed=4)
    assert not bool((args[6] if form == "gather" else args[4]).any())
    assert torch.equal(fn(*args, **kw), fn(*args_n, **kw_n))


def test_scene_kernels_refuse_operands_they_do_not_take(card_db):
    fn, args, kw = _scene(card_db, "apply", 264)
    bad = list(args)
    bad[0] = args[0][:, :500]
    with pytest.raises(ValueError, match="xdr: want contiguous"):
        fn(*bad, **kw)
    with pytest.raises(ValueError, match="icr: want contiguous .*96"):  # the 128-sample basis
        fn(*args, **{**kw, "fpb": 96})
    fn, args, kw = _scene(card_db, "gather", 264)
    with pytest.raises(ValueError, match="g_last: want"):
        fn(*args[:5], args[5][:-1], args[6], **kw)


# (positions, chunk_blocks, options) of a small render per scene arm
_SCENE_RENDERS = {
    "dedup_fused_sparse": (lambda: bench.scene_hold_positions(4, 600, 100), 256, {}),
    "dedup_fused": (lambda: bench.scene_hold_positions(4, 600, 100), 256,
                    {"sparse_xfade": False}),
    "onehot_grouped": (lambda: bench.scene_mover_positions(16, 300), 256, {}),
    "gather_fused": (lambda: bench.wide_positions(4, 300), 256, {}),
    "apply_only_sparse": (lambda: bench.scene_hold_positions(4, 600, 100), 512, {}),
    "apply_only_dedup": (lambda: bench.scene_hold_positions(4, 600, 100), 512,
                         {"sparse_xfade": False}),
    "apply_only_gather": (lambda: bench.wide_positions(2, 600), 512, {}),
}


@pytest.mark.parametrize("case", list(_SCENE_RENDERS))
def test_scene_render_on_the_card_matches_the_cpu_twins(card_db, case):
    positions, cb, opts = _SCENE_RENDERS[case]
    pos = positions()
    noise = np.random.default_rng(0).standard_normal(131072).astype(np.float32) * 0.2
    sig = bench.scene_signals(noise, pos.shape[0], pos.shape[1])
    card = BatchRenderer(card_db, device="cuda", chunk_blocks=cb, **opts)
    tfs.reset_launches()
    got = card.render(sig, pos)
    _one_step_a_chunk_and_the_pre_blends(card.dispatch)
    cpu = BatchRenderer(card_db, device="cpu", chunk_blocks=cb, **opts)
    want = cpu.render(sig, pos)
    assert card.dispatch == cpu.dispatch
    assert np.abs(got - want).max() <= TOL


def _count_side_copies(monkeypatch):
    """Count the pinned side-stream copies of ChunkFetch."""
    from jefferson_tpu_torch.engine import renderer as trenderer

    copies, copy = [], trenderer.ChunkFetch._copy
    monkeypatch.setattr(trenderer.ChunkFetch, "_copy",
                        lambda self, y: copies.append(y.shape) or copy(self, y))
    return copies


@pytest.mark.parametrize("case", ["scene_hold", "scene_movers", "wide_mix"])
def test_pipelined_scene_render_equals_synchronous_on_the_card(card_db, case, monkeypatch):
    """pipeline_fetch=True: each chunk's output on a side stream into pinned
    slots, read one chunk late, torch.equal to the synchronous render (a
    padded final chunk included)."""
    pos = {"scene_hold": lambda: bench.scene_hold_positions(8, 1100, 100),
           "scene_movers": lambda: bench.scene_mover_positions(16, 700),
           "wide_mix": lambda: bench.wide_positions(4, 700)}[case]()
    noise = np.random.default_rng(1).standard_normal(131072).astype(np.float32) * 0.2
    sig = bench.scene_signals(noise, pos.shape[0], pos.shape[1])
    mix = case.endswith("mix")
    sync = BatchRenderer(card_db, device="cuda", chunk_blocks=256, mix=mix)
    want = sync.render(sig, pos)
    copies = _count_side_copies(monkeypatch)
    piped = BatchRenderer(card_db, device="cuda", chunk_blocks=256, mix=mix, pipeline_fetch=True)
    got = piped.render(sig, pos)
    assert len(copies) == len(piped.dispatch) == len(sync.dispatch) > 2
    assert piped.dispatch == sync.dispatch
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


@pytest.mark.parametrize("opts", [{}, {"sparse_xfade": False}, {"fused": False}])
def test_pipelined_sweep_render_equals_synchronous_on_the_card(card_db, opts, monkeypatch):
    pos = bench.sweep_positions(3.0, 5.0)[:5000]
    sig = np.random.default_rng(2).standard_normal(131072).astype(np.float32) * 0.2
    want = Renderer(card_db, device="cuda", chunk_blocks=2048, **opts).render(sig, pos)
    copies = _count_side_copies(monkeypatch)
    r = Renderer(card_db, device="cuda", chunk_blocks=2048, pipeline_fetch=True, **opts)
    got = r.render(sig, pos)
    assert len(copies) == len(r.dispatch) == 3
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


# ---- launch B's split form (rows 2-8) ----------------------------------------

_SPLIT_SCENE = {"gather": "fused_step_xfade", "gather_noxf": "fused_step_xfade/no_xfade",
                "grouped": tfs.GROUPED}
_SPLIT_GROUPS = {8: 1, 264: 1, 4096: 4}  # row 2's sources per group: ends inside tiles at 264


def _both_forms(fn, args, kw):
    """The step on the same operands in each of launch B's forms, through
    the wrappers' private seam."""
    return {form: tfs._cuda(fn, *args, form=form, **kw) for form in (tfs.LAUNCH_B, tfs.SPLIT)}


def _split_agrees(fn, args, kw, name):
    tfs.reset_launches()
    ys = _both_forms(fn, args, kw)
    torch.cuda.synchronize()
    assert tfs.launches[name] == 2 and tfs.split_launches[name] == 1
    assert torch.equal(ys[tfs.SPLIT], ys[tfs.LAUNCH_B])
    assert float((ys[tfs.SPLIT] - _twin(fn)(*args, **kw)).abs().max()) <= TOL


@pytest.mark.parametrize("rows", [8, 264, 4096])
@pytest.mark.parametrize("form", list(_SPLIT_SCENE))
@pytest.mark.parametrize("duplicate", [False, True])
def test_split_form_is_launch_b_bit_for_bit(card_db, form, rows, duplicate):
    """Rows 6 (both forms) and 2: at 264 rows (4 x 66) segment ends, and row
    2's group ends, fall inside 32-row tiles."""
    groups = {"group_sources": _SPLIT_GROUPS[rows]} if form == "grouped" else {}
    fn, args, kw = _scene(card_db, form, rows, xf_every=5, duplicate=duplicate, **groups)
    _split_agrees(fn, args, kw, _SPLIT_SCENE[form])


@pytest.mark.parametrize("dist", list(_DISTANCE))
def test_split_form_on_ids_outside_a_groups_table(card_db, dist):
    fn, args, kw = _scene(card_db, "grouped", 264, group_sources=1, **_DISTANCE[dist])
    args = list(args)
    u = args[4].shape[0] // 4  # four groups of one source
    args[5], args[7] = args[5].clone(), args[7].clone()
    args[5][3, 1], args[5][100, 0], args[5][65, 2], args[7][-1, 2], args[7][0, 3] = u, -4, u, 3 * u, -1
    _split_agrees(fn, args, kw, tfs.GROUPED)


@pytest.mark.parametrize("b", [8, 264, 2048])
@pytest.mark.parametrize("form", bench.STREAM_FORMS)
def test_split_form_of_the_stream_steps_is_launch_b_bit_for_bit(card_db, form, b):
    fn, args, kw = _stream(card_db, form, b, radius_step=0.01, xf_every=5)
    _split_agrees(fn, args, kw, tfs.NO_XFADE if form == "gather_noxf" else fn.__name__)


@pytest.mark.parametrize("rows", [8, 264, 4096])
@pytest.mark.parametrize("form", ["apply", "apply_noxf"])
def test_split_form_of_the_apply_step_is_launch_b_bit_for_bit(card_db, form, rows):
    fn, args, kw = _scene(card_db, form, rows, xf_every=5)
    _split_agrees(fn, args, kw, tfa.NO_XFADE if form == "apply_noxf" else "fused_apply_xfade")


def test_row_1_has_launch_b_only(card_db):
    args, kw = _operands(card_db, 0.0)
    with pytest.raises(ValueError, match="launch B only"):
        tfs._cuda(tfs.fused_step_onehot_xfade, *args, form=tfs.SPLIT, **kw)


def test_a_refused_split_launch_raises(card_db, monkeypatch):
    """The entry refuses a form it does not know and returns the error; the
    wrapper raises, and nothing falls back to launch B or the twin."""
    fn, args, kw = _scene(card_db, "gather", 264)
    monkeypatch.setitem(tfs._FORM_CODE, tfs.SPLIT, 7)
    tfs.reset_launches()
    with pytest.raises(RuntimeError, match="fused_step_xfade launch failed: CUDA error"):
        tfs._cuda(fn, *args, form=tfs.SPLIT, **kw)
    assert sum(tfs.launches.values()) == 0


# ---- launch B's split form past one t-tile or eight tail blocks -------------

# fpb 2048 / pad 4096 (16 tail blocks, 16 t-tiles), 128 / 4096 (16 blocks),
# 441 / 1024 (a history of partial blocks: rows 7 and 8 alone; 3 t-tiles and
# a ragged one of 57 columns, rows of 441 floats) and 1024 / 2048 (8 t-tiles)
_WIDE = ("f2048", "f128t2048", "f441", "f1024")
_WIDE_GROUPING = {8: (8, 1), 264: (8, 3), 4096: (256, 2)}  # stream rows -> (tb, group_tiles)
# fpb 64 over 512 and 256 taps, 16 and 4 (launch A's planes form) and 2 (no
# split form): launch B's and the chunked layout's tile fpb columns wide
_FIT = ("f64", "f64t256", "f16", "f4", "f2")
ROW8_TOL = 1e-5  # row 8 vs twin: its blend over the full table, as chip_smoke.py


def _fit_forms(fn, args, kw, forms, rows, fpb, tol=TOL):
    """The step in each of ``forms`` (launch B, and the split form where the
    geometry has it): torch.equal, each held to the twin at ``tol``."""
    got = [tfs._cuda(fn, *args, form=f, **kw) for f in forms]
    torch.cuda.synchronize()
    want = _twin(fn)(*args, **kw)
    for g in got:
        assert g.shape == (rows, 2 * fpb) and torch.equal(g, got[0])
        assert float((g - want).abs().max()) <= tol


def _split_is_launch_b(call):
    """The step in launch B, then in the split form (in the layout its
    library takes, fused_step.split_default), through the private seams:
    torch.equal."""
    want = call(tfs.LAUNCH_B)
    got = call(tfs.SPLIT)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("rows", [8, 264, 4096])
@pytest.mark.parametrize("name", _WIDE)
def test_split_form_at_the_wide_geometries_is_launch_b_bit_for_bit(name, rows):
    """Rows 2-7, with and without the crossfade, the split form against
    launch B: at 264 rows segment and group ends fall inside tiles and the
    brackets repeat one id; the library reports the form."""
    db = _geo_db(name)
    fpb, pad = db.config.frames_per_buffer, db.config.pad_len
    forms = tfs.geometry_forms(fpb, pad)
    assert forms.split and tfs.library_geometry("fused_step_gather", fpb, pad).split
    assert tfs.library_geometry("fused_step_onehot", fpb, pad).split
    dev = torch.device("cuda", 0)
    s_, nb = _SCENE_SHAPES[rows]
    tfs.reset_launches()
    steps = 0
    for form in ("apply", "apply_noxf") + (("gather", "gather_noxf", "grouped") if forms.q else ()):
        groups = {"group_sources": _SPLIT_GROUPS[rows]} if form == "grouped" else {}
        fn, args, kw = bench.scene_step(db, form, s_, nb, dev, xf_every=5,
                                        duplicate=rows == 264, **groups)
        want = _split_is_launch_b(lambda f: tfs._cuda(fn, *args, form=f, **kw))
        assert want.shape == (rows, 2 * fpb)
        steps += 1
    if forms.q:
        tb, gt = _WIDE_GROUPING[rows]
        for form in bench.STREAM_FORMS:
            fn, args, kw = bench.stream_step(db, form, rows, dev, tb=tb, group_tiles=gt,
                                             radius_step=0.01, xf_every=5)
            _split_is_launch_b(lambda f: tfs._cuda(fn, *args, form=f, **kw))
            steps += 1
    assert sum(tfs.split_launches.values()) == steps


@pytest.mark.parametrize("name", ["f2048", "f128t2048", "f1024", *_FIT])
def test_split_form_at_the_wide_geometries_on_ids_outside_a_groups_table(name):
    """Row 2 with ids outside its groups' tables: the split form (where the
    geometry has it) torch.equal to launch B, both within TOL of the twin;
    where the tile fits the block too (_FIT)."""
    db = _geo_db(name)
    fpb, pad = db.config.frames_per_buffer, db.config.pad_len
    tail = [tfs.LAUNCH_B] + ([tfs.SPLIT] if tfs.geometry_forms(fpb, pad).split else [])
    fn, args, kw = bench.scene_step(db, "grouped", 4, 66, torch.device("cuda", 0),
                                    group_sources=1, radius_step=0.01, xf_every=3)
    args = list(args)
    u = args[4].shape[0] // 4  # four groups of one source
    args[5], args[7] = args[5].clone(), args[7].clone()
    args[5][3, 1], args[5][100, 0], args[5][65, 2] = u, -4, u
    args[7][-1, 2], args[7][0, 3] = 3 * u, -1
    _fit_forms(fn, args, kw, tail, 264, fpb)


@pytest.mark.parametrize("rows", [8, 264, 4096])
@pytest.mark.parametrize("name", _WIDE + _FIT)
def test_spatializer_split_form_at_the_wide_geometries_is_launch_b_bit_for_bit(name, rows):
    """Row 8's split form (where the geometry has it) against launch B:
    random and duplicate brackets with ids outside the table, with the
    crossfade and at xf = 0; both within ROW8_TOL of the twin."""
    db = _geo_db(name)
    cfg = db.config
    fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
    geo = dict(pad_len=pad, bins=bins, fpb=fpb)
    split = tfs.geometry_forms(fpb, pad).split
    dev = torch.device("cuda", 0)
    tfs.reset_launches()
    for duplicate in (False, True):
        table, fwd, br, xf = bench.spatializer_step(db, rows, dev, duplicate=duplicate, seed=4)
        br = tuple(t.clone() for t in br)
        br[0][0, 1], br[2][rows - 1, 3], br[2][rows // 2, 0] = db.num_hrtf, -1, 9000
        if tfs.geometry_forms(fpb, pad).q:
            xd = tfs._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
        else:
            from jefferson_tpu_torch.engine.stream import _window_xd

            xd = _window_xd(fwd[0].unfold(0, pad, fpb), *fwd[1:], cfg)
        for x in (xf, torch.zeros_like(xf)):
            want = tsp.fused_apply_reference(table, *xd, *br, x, bins=bins, fpb=fpb)
            call = lambda f: tsp._cuda(dev, rows, table, br, x, *xd, None, form=f, **geo)
            got = _split_is_launch_b(call) if split else call(tfs.LAUNCH_B)
            assert float((got - want).abs().max()) <= ROW8_TOL
    assert tfs.spatializer_forms == {"cluster": 0, "launch_b": 4, "split": 4 if split else 0}


@pytest.mark.parametrize("name", _WIDE)
def test_split_layouts_script_on_the_card(name):
    """scripts/split_layouts.py at rows 7 and 8 (the split form torch.equal
    to launch B, times beside the twin and the bound, two readings in turns
    at one crossover count)."""
    _geo_db(name)
    from jefferson_tpu_torch.scripts import split_layouts

    got = split_layouts.measure(name, kernels=["fused_apply_xfade", tfs.SPATIALIZER],
                                cross=(64,), repeat=2)
    for kernel, res in got["kernels"].items():
        assert res["equal"]
        assert res["layout"] == tfs.split_default(kernel, got["fpb"])
        assert 0 < res["bound_ms"] < res["alone"][tfs.SPLIT]
        assert [len(res["cross"][64][f]) for f in (tfs.LAUNCH_B, tfs.SPLIT)] == [2, 2]


# ---- the split form's pipelined layout, past one t-tile ---------------------

# fpb 256 and 512 (pad 1024: 4 tail blocks, 2 and 4 t-tiles), 1024 (8 and
# 8), 2048 (16 and 16) and 441 (rows 7 and 8; a ragged t-tile, rows of 441
# floats); rows -> (sources, blocks): one row, 17 rows, R + 1 crossfading
# rows (33), R + 1 rows of one side (65), and 512 and 4,096 rows, the last
# tile ragged
_PIPE = ("f256", "f512", "f1024", "f2048", "f441")
_PIPE_SHAPES = {1: (1, 1), 17: (1, 17), 33: (3, 11), 65: (5, 13), 512: (2, 256),
                4096: (16, 256)}


@pytest.mark.parametrize("rows", list(_PIPE_SHAPES))
@pytest.mark.parametrize("name", _PIPE)
def test_pipelined_layout_is_launch_b_bit_for_bit(name, rows):
    """The split form in the layout each library reports (the pipelined one
    for blended rows everywhere here, for pre-blended rows at f2048), each
    torch.equal to launch B: rows 6 and 7 pre-blended, with and without
    the crossfade (two sides and one), row 2 blended in groups of one
    source (group ends on segment ends) with ids outside its groups'
    tables, row 8 with ids outside the table."""
    db = _geo_db(name)
    cfg = db.config
    fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
    forms = tfs.geometry_forms(fpb, pad)
    assert forms.layouts[0] == tfs.SPLIT_PIPE
    for lib in tbuild.GEOMETRIC:
        assert tfs.library_geometry(lib, fpb, pad).layouts == forms.layouts
    dev = torch.device("cuda", 0)
    s_, nb = _PIPE_SHAPES[rows]
    tfs.reset_launches()
    steps = 0
    for form in ("apply", "apply_noxf") + (("gather", "gather_noxf", "grouped") if forms.q else ()):
        groups = {"group_sources": 1} if form == "grouped" else {}
        fn, args, kw = bench.scene_step(db, form, s_, nb, dev, xf_every=5, radius_step=0.01,
                                        **groups)
        if form == "grouped":
            args = list(args)
            u = args[4].shape[0] // s_  # groups of one source
            args[5], args[7] = args[5].clone(), args[7].clone()
            args[5][0, 1], args[5][rows - 1, 0], args[7][-1, 2] = u, -4, 3 * u
        want = _split_is_launch_b(lambda f: tfs._cuda(fn, *args, form=f, **kw))
        assert want.shape == (rows, 2 * fpb)
        steps += 1
    assert sum(tfs.split_launches.values()) == steps
    geo = dict(pad_len=pad, bins=bins, fpb=fpb)
    table, fwd, br, xf = bench.spatializer_step(db, rows, dev, seed=5)
    br = tuple(t.clone() for t in br)
    br[0][0, 1], br[2][rows - 1, 3] = db.num_hrtf, -1
    if forms.q:
        xd = tfs._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
    else:
        from jefferson_tpu_torch.engine.stream import _window_xd

        xd = _window_xd(fwd[0].unfold(0, pad, fpb), *fwd[1:], cfg)
    _split_is_launch_b(lambda f: tsp._cuda(dev, rows, table, br, xf, *xd, None, form=f, **geo))
    assert tfs.spatializer_forms[tfs.SPLIT] == 1


@pytest.mark.parametrize("name", _PIPE + ("f128t2048",))
def test_split_occupancy_of_the_layout_each_library_takes(name):
    """The card holds at least one cluster of the split form in the layout
    each library reports (the pipelined one: one CTA an SM), and the query
    raises where a geometry has no split form."""
    db = _geo_db(name)
    fpb, pad = db.config.frames_per_buffer, db.config.pad_len
    for lib, sides in (("fused_step_onehot", 2), ("fused_step_gather", 2),
                       ("fused_step_gather", 1)):
        occ = tfs.split_occupancy(lib, fpb, pad, sides)
        assert occ["layout"] == tfs.geometry_forms(fpb, pad).layouts[lib == "fused_step_gather"]
        assert occ["clusters"] >= 1 and occ["ranks"] == (pad // 2) // 128
        if occ["layout"] == tfs.SPLIT_PIPE:  # 256 multiply threads and 64 fold threads
            assert occ["ctas_per_sm"] == 1 and occ["threads"] == 320
    _geo_db("f2")
    with pytest.raises(RuntimeError, match="occupancy"):
        tfs.split_occupancy("fused_step_gather", 2, 1024)


# ---- kernel row 8 and the live path ------------------------------------------

def _spatializer(db, rows, **kw):
    table, fwd, br, xf = bench.spatializer_step(db, rows, torch.device("cuda", 0), **kw)
    geo = dict(pad_len=1024, bins=513, fpb=128)
    xdr, xdi = tfs._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
    return table, fwd, br, xf, (xdr, xdi), geo


@pytest.mark.parametrize("rows", [1, 4096])
@pytest.mark.parametrize("duplicate", [False, True])
def test_spatializer_kernel_matches_twin(card_db, rows, duplicate):
    table, fwd, br, xf, xd, geo = _spatializer(card_db, rows, duplicate=duplicate)
    before = tfs.launches[tfs.SPATIALIZER]
    got = tsp.fused_apply(table, *xd, *br, xf, bins=513, fpb=128)
    scratch = (torch.empty_like(xd[0]), torch.empty_like(xd[1]))
    got_f = tsp.fused_forward_apply(table, *fwd, *br, xf, scratch=scratch, **geo)
    torch.cuda.synchronize()
    assert tfs.launches[tfs.SPATIALIZER] == before + 2
    want = tsp.fused_apply_reference(table, *xd, *br, xf, bins=513, fpb=128)
    assert got.shape == want.shape == (rows, 256)
    assert float((got - want).abs().max()) <= TOL
    want_f = tsp.fused_forward_apply_reference(table, *fwd, *br, xf, **geo)
    assert float((got_f - want_f).abs().max()) <= TOL
    peak = max(float(xd[0].abs().max()), float(xd[1].abs().max()))
    for mine, twin in zip(scratch, xd):  # launch A at nb = rows, one stream
        assert float((mine - twin).abs().max()) <= 1e-6 * peak


def test_spatializer_no_crossfade_use_is_bit_equal(card_db):
    table, _, br, xf, xd, _ = _spatializer(card_db, 264, seed=3)
    held = torch.zeros_like(xf)
    y_xf = tsp.fused_apply(table, *xd, *br, held, bins=513, fpb=128)
    y_noxf = tsp.fused_apply(table, *xd, br[2], br[3], br[2], br[3], held, bins=513, fpb=128)
    assert torch.equal(y_xf, y_noxf)


def _spatializer_form(form, table, xd, br, xf):
    """Row 8 in a named form, through the wrapper's private seam."""
    return tsp._cuda(xd[0].device, xd[0].shape[0], table, br, xf, *xd, None, pad_len=1024,
                     bins=513, fpb=128, form=form)


@pytest.mark.parametrize("rows", [1, 2, 7, tsp.SMALL_ROWS, 200])
@pytest.mark.parametrize("duplicate", [False, True])
def test_spatializer_cluster_form_is_launch_b_bit_for_bit(card_db, rows, duplicate):
    """The two forms on the same operands: the cluster form keeps launch B's
    blocked order, so the bits agree, also with the new brackets on both
    sides and xf = 0 (the held block's use)."""
    table, fwd, br, xf, xd, geo = _spatializer(card_db, rows, duplicate=duplicate)
    if rows > 1:  # ids outside the table in both sides
        br = tuple(t.clone() for t in br)
        br[0][0, 1], br[2][rows - 1, 3], br[2][rows // 2, 0] = 710, -1, 9000
    tfs.reset_launches()
    ys = {form: _spatializer_form(form, table, xd, br, xf) for form in (tsp.CLUSTER, tsp.LAUNCH_B)}
    no_xf = (br[2], br[3], br[2], br[3])
    off = torch.zeros_like(xf)
    held = {form: _spatializer_form(form, table, xd, no_xf, off)
            for form in (tsp.CLUSTER, tsp.LAUNCH_B)}
    torch.cuda.synchronize()
    assert tfs.launches[tfs.SPATIALIZER] == 4
    assert tfs.spatializer_forms == {"cluster": 2, "launch_b": 2, "split": 0}
    assert torch.equal(ys[tsp.CLUSTER], ys[tsp.LAUNCH_B])
    assert torch.equal(held[tsp.CLUSTER], held[tsp.LAUNCH_B])
    kw = dict(bins=513, fpb=128)
    want = tsp.fused_apply_reference(table, *xd, *br, xf, **kw)
    assert float((ys[tsp.CLUSTER] - want).abs().max()) <= TOL
    want_held = tsp.fused_apply_reference(table, *xd, *no_xf, off, **kw)
    assert float((held[tsp.CLUSTER] - want_held).abs().max()) <= TOL


@pytest.mark.parametrize("rows", [1, 7, 264, 4096])
@pytest.mark.parametrize("duplicate", [False, True])
def test_spatializer_split_form_is_launch_b_bit_for_bit(card_db, rows, duplicate):
    """Row 8's split form (segments of one row: every new side a boundary
    row) against launch B, with the crossfade and at xf = 0."""
    table, fwd, br, xf, xd, geo = _spatializer(card_db, rows, duplicate=duplicate)
    if rows > 1:
        br = tuple(t.clone() for t in br)
        br[0][0, 1], br[2][rows - 1, 3], br[2][rows // 2, 0] = 710, -1, 9000
    tfs.reset_launches()
    ys = {form: _spatializer_form(form, table, xd, br, xf) for form in (tsp.SPLIT, tsp.LAUNCH_B)}
    off = torch.zeros_like(xf)
    held = {form: _spatializer_form(form, table, xd, br, off) for form in (tsp.SPLIT, tsp.LAUNCH_B)}
    torch.cuda.synchronize()
    assert tfs.spatializer_forms == {"cluster": 0, "launch_b": 2, "split": 2}
    assert torch.equal(ys[tsp.SPLIT], ys[tsp.LAUNCH_B])
    assert torch.equal(held[tsp.SPLIT], held[tsp.LAUNCH_B])
    want = tsp.fused_apply_reference(table, *xd, *br, xf, bins=513, fpb=128)
    assert float((ys[tsp.SPLIT] - want).abs().max()) <= TOL


@pytest.mark.parametrize("rows", [1, 9])
def test_spatializer_forward_form_agrees_with_launch_b(card_db, rows):
    """Launch A then the picked form (the cluster form at these rows), and
    launch B on the XD planes it wrote: the same bits."""
    table, fwd, br, xf, _, geo = _spatializer(card_db, rows, seed=2)
    scratch = tuple(torch.empty((rows, 513), device="cuda") for _ in range(2))
    tfs.reset_launches()
    got = tsp.fused_forward_apply(table, *fwd, *br, xf, scratch=scratch, **geo)
    again = _spatializer_form(tsp.LAUNCH_B, table, scratch, br, xf)
    torch.cuda.synchronize()
    assert tfs.spatializer_forms == {"cluster": 1, "launch_b": 1, "split": 0}
    assert torch.equal(got, again)
    want = tsp.fused_forward_apply_reference(table, *fwd, *br, xf, **geo)
    assert float((got - want).abs().max()) <= TOL


def test_spatializer_kernel_on_ids_outside_the_table(card_db):
    table, _, br, xf, xd, _ = _spatializer(card_db, 40)
    idx_o, idx_n = br[0].clone(), br[2].clone()
    idx_o[3, 1], idx_o[17, 0], idx_n[5, 2], idx_n[39, 3] = 710, -1, 900, -7
    args = (table, *xd, idx_o, br[1], idx_n, br[3], xf)
    got = tsp.fused_apply(*args, bins=513, fpb=128)
    want = tsp.fused_apply_reference(*args, bins=513, fpb=128)
    assert float((got - want).abs().max()) <= TOL


def test_render_scan_on_the_card_matches_the_cpu_twins_and_oracle(card_db):
    pos = bench.mover_positions(700)
    sig = np.random.default_rng(0).standard_normal(40000).astype(np.float32) * 0.2
    tfs.reset_launches()
    got = render_scan(sig, card_db, pos, device="cuda", chunk_blocks=256)
    assert tfs.launches[tfs.SPATIALIZER] == 3
    want = render_scan(sig, card_db, pos, device="cpu", chunk_blocks=256)
    assert np.abs(got - want).max() <= TOL
    oracle = render_oracle(sig, card_db, [tuple(p) for p in pos], card_db.config)
    assert np.abs(got - oracle).max() <= 1e-6


def test_live_stream_on_the_card_matches_the_oracle(card_db):
    pos = bench.helix_positions(300)
    pos[::4] = pos[1::4]  # some held blocks: the no-crossfade step
    sig = np.random.default_rng(1).standard_normal(20000).astype(np.float32) * 0.2
    sp = StreamingSpatializer(card_db, device="cuda")
    sp.buf = sig
    sp.prime()
    tfs.reset_launches()
    outs = []
    for azi, ele, r in pos:
        sp.set_position(azi=azi, ele=ele, r=r)
        outs.append(sp.process_next())
    assert tfs.launches[tfs.SPATIALIZER] == len(pos)
    assert sum(tfs.launches.values()) == len(pos)
    assert 0 < sp.crossfades < len(pos)
    # one row: every block, moving or held, takes the cluster form
    assert tfs.spatializer_forms == {"cluster": len(pos), "launch_b": 0, "split": 0}
    oracle = render_oracle(sig, card_db, [tuple(p) for p in pos], card_db.config)
    assert np.abs(np.concatenate(outs) - oracle).max() <= 1e-6


def test_live_block_deadline_strict(card_db):
    """tests/test_live_deadline_strict.py's gate on the card: 200 blocks that
    crossfade every block, median under the 2.902 ms budget and p90 under
    twice it."""
    cfg = DEFAULT_CONFIG
    spat = StreamingSpatializer(card_db, cfg, device="cuda")
    blk = (np.random.default_rng(0).standard_normal(cfg.frames_per_buffer) * 0.2).astype(np.float32)
    spat.prime()
    spat.set_position(azi=3, ele=10, r=1.0)
    spat.process_block(blk)
    times = np.empty(200)
    for i in range(200):
        spat.set_position(azi=(i * 3) % 360, ele=10, r=1.0)  # crossfade every block
        t0 = time.perf_counter()
        spat.process_block(blk)
        times[i] = time.perf_counter() - t0
    ms, budget = times * 1e3, 1e3 * cfg.block_duration
    assert np.percentile(ms, 50) < budget, ms
    assert np.percentile(ms, 90) < 2 * budget, ms


# ---- the probe kernels (rows 9-12) ---------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _planes(card, rows, k, seed=0):
    """(xr, xi, gr, gi, icr, ici) on the card: the probe's magnitudes at
    ``rows`` x ``k``, the tail basis cut to k rows."""
    rng = np.random.default_rng(seed)
    dec = np.exp(-np.arange(k) / 200.0)
    x = [rng.standard_normal((rows, k)) * 8 for _ in range(2)]
    g = [rng.standard_normal((rows, k)) * dec for _ in range(2)]
    icr, ici = (b[:k] for b in sap.inputs()[4:])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(card)
    return tuple(map(put, (*x, *g, icr, ici)))


@pytest.mark.parametrize("rows,k", [(256, 513), (8, 513), (264, 512)])
def test_prod_kernel_matches_twin(card, rows, k):
    xr, xi, gr, gi, _, _ = _planes(card, rows, k)
    before = tfs.launches["prod"]
    got = tap.prod(xr, xi, gr, gi)
    torch.cuda.synchronize()
    assert tfs.launches["prod"] == before + 1
    want = tap.prod_reference(xr, xi, gr, gi)
    scales = ((xr * gr).abs() + (xi * gi).abs(), (xr * gi).abs() + (xi * gr).abs())
    for g, w, sc in zip(got, want, scales):
        assert bool(((g - w).abs() <= 2.0**-22 * sc).all())


@pytest.mark.parametrize("rows", [8, 256, 264])
@pytest.mark.parametrize("k", [512, 513])
def test_mm_kernel_matches_twin(card, rows, k):
    xr, xi, gr, gi, icr, ici = _planes(card, rows, k)
    qr, qi = tap.prod_reference(xr, xi, gr, gi)
    before = tfs.launches["mm"]
    got = tap.mm(qr, qi, icr, ici)
    torch.cuda.synchronize()
    assert tfs.launches["mm"] == before + 1
    want = tap.mm_reference(qr, qi, icr, ici)
    assert got.shape == (rows, 128)
    assert float((got - want).abs().max()) <= MM_REL * float(want.abs().max())


@pytest.mark.parametrize("rows", [8, 264])
@pytest.mark.parametrize("k,chunks", [(512, 2), (512, 4), (512, 8), (513, 3)])
def test_mm_tree_kernel_matches_twin(card, rows, k, chunks):
    """K = 513 in 3 chunks carries the tree's odd part."""
    xr, xi, gr, gi, icr, ici = _planes(card, rows, k)
    qr, qi = tap.prod_reference(xr, xi, gr, gi)
    before = tfs.launches["mm_tree"]
    got = tap.mm_tree(qr, qi, icr, ici, chunks)
    torch.cuda.synchronize()
    assert tfs.launches["mm_tree"] == before + 1
    want = tap.mm_tree_reference(qr, qi, icr, ici, chunks)
    assert float((got - want).abs().max()) <= MM_REL * float(want.abs().max())


def test_mm_tree_of_one_chunk_is_mm_on_the_card(card):
    xr, xi, gr, gi, icr, ici = _planes(card, 264, 513)
    qr, qi = tap.prod_reference(xr, xi, gr, gi)
    assert torch.equal(tap.mm_tree(qr, qi, icr, ici, 1), tap.mm(qr, qi, icr, ici))


def test_probe_kernels_refuse_chunks_on_the_card(card):
    xr, xi, gr, gi, icr, ici = _planes(card, 8, 513)
    with pytest.raises(ValueError, match="does not divide"):
        tap.mm_tree(xr, xi, icr, ici, 2)
    with pytest.raises(ValueError, match="gi: want contiguous"):
        tap.prod(xr, xi, gr, gi.double())


@pytest.mark.parametrize("chunks", [1, 8, 16])
def test_mm_tree_at_k_past_a_ctas_shared_memory(card, chunks):
    """K = 8,192: all of q's K no longer sits in a CTA (256 KB at 4 rows);
    the kernel tiles K through shared memory.  Small integers over 64 keep
    every product and partial sum exact in fp32 (|sum| <= 2^17 at steps of
    2^-6: 23 bits), so every order of the sums gives the same bits: the kernel equals
    its twin and the float64 product exactly."""
    rng = np.random.default_rng(9)
    put = lambda a: torch.from_numpy(a.astype(np.float32)).to(card)
    qr, qi = (put(rng.integers(-8, 9, (24, 8192))) for _ in range(2))
    icr, ici = (put(rng.integers(-64, 65, (8192, 128)) / 64) for _ in range(2))
    got = tap.mm(qr, qi, icr, ici) if chunks == 1 else tap.mm_tree(qr, qi, icr, ici, chunks)
    want = (tap.mm_reference(qr, qi, icr, ici) if chunks == 1
            else tap.mm_tree_reference(qr, qi, icr, ici, chunks))
    exact = (qr.double() @ icr.double() + qi.double() @ ici.double()).float()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, exact)


def test_a_refused_mm_launch_does_not_leak_into_the_next(card):
    """An empty grid is refused: the entry returns the CUDA error, nothing
    is counted, and the refusal is not the next launch's error."""
    xr, xi, gr, gi, icr, ici = _planes(card, 8, 513)
    y = torch.empty((8, 128), device=card)
    err = tap._lib().jt_mm_tree(card.index, torch.cuda.current_stream(card).cuda_stream,
                                xr.data_ptr(), xi.data_ptr(), icr.data_ptr(), ici.data_ptr(),
                                y.data_ptr(), 0, 513, 128, 1)
    assert err != 0
    assert "invalid" in tfs._cuda_error("assoc_probe", err)
    before = tfs.launches["mm"]
    tap.prod(xr, xi, gr, gi)
    got = tap.mm(xr, xi, icr, ici)
    torch.cuda.synchronize()
    assert tfs.launches["mm"] == before + 1
    want = tap.mm_reference(xr, xi, icr, ici)
    assert float((got - want).abs().max()) <= MM_REL * float(want.abs().max())


def test_mm_tree_takes_a_basis_off_the_16_byte_pieces(card):
    """N = 126 (rows of 504 bytes): the basis is staged 4 bytes at a time."""
    xr, xi, gr, gi, icr, ici = _planes(card, 10, 512)
    qr, qi = tap.prod_reference(xr, xi, gr, gi)
    icr, ici = icr[:, :126].contiguous(), ici[:, :126].contiguous()
    got = tap.mm_tree(qr, qi, icr, ici, 4)
    want = tap.mm_tree_reference(qr, qi, icr, ici, 4)
    assert got.shape == (10, 126)
    assert float((got - want).abs().max()) <= MM_REL * float(want.abs().max())


def test_assoc_probe_names_the_cards_contraction(card):
    """Stage A: each plane of the kernel is one FMA form on every element."""
    res = sap.run(card)
    for counts in res["A"]["kernel_equals"].values():
        assert max(counts.values()) == sap.B * sap.BINS
    assert res["A"]["err_kernel"] <= res["A"]["err_torch"]


def _blend(card, r, c_pad=2176, seed=5):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((710, c_pad)).astype(np.float32)
    idx = rng.integers(0, 710, (r, 4)).astype(np.int32)
    w = rng.random((r, 4)).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(card)
    return put(table.reshape(-1)), put(idx), put(w), c_pad


@pytest.mark.parametrize("r,tb", [(8448, 256), (12, 4), (264, 8), (1, 1)])
def test_dma_blend_kernel_is_its_twin(card, r, tb):
    """Row counts off the kernel's 8-row tile, and the script's shape."""
    flat, idx, w, c_pad = _blend(card, r)
    before = tfs.launches["dma_blend"]
    got = tdb.dma_blend(flat, idx, w, c_pad, tb=tb)
    torch.cuda.synchronize()
    assert tfs.launches["dma_blend"] == before + 1
    assert torch.equal(got, tdb.dma_blend_reference(flat, idx, w, c_pad, tb=tb))


@pytest.mark.parametrize("c_pad", [128, 1024, 4096])
def test_dma_blend_kernel_at_other_widths(card, c_pad):
    flat, idx, w, c_pad = _blend(card, 40, c_pad)
    got = tdb.dma_blend(flat, idx, w, c_pad, tb=8)
    assert torch.equal(got, tdb.dma_blend_reference(flat, idx, w, c_pad, tb=8))


def test_dma_blend_kernel_on_ids_outside_the_table(card):
    flat, idx, w, c_pad = _blend(card, 24)
    idx = idx.clone()
    idx[3, 1], idx[5, 0], idx[17, 3] = 712, -4, 710
    got = tdb.dma_blend(flat, idx, w, c_pad, tb=8)
    assert torch.equal(got, tdb.dma_blend_reference(flat, idx, w, c_pad, tb=8))
    ok = w.clone()
    ok[3, 1], ok[5, 0], ok[17, 3] = 0.0, 0.0, 0.0
    fixed = torch.where(ok > 0, idx, 0)
    assert torch.equal(got, tdb.dma_blend_reference(flat, fixed, ok, c_pad, tb=8))


def test_dma_blend_kernel_matches_the_torch_gathers(card):
    idx, w = sbb.workload(264)
    table, table_pad = sbb.tables()
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    got = tdb.dma_blend(put(table_pad.reshape(-1)), put(idx), put(w), table_pad.shape[1], tb=8)
    planes = tuple(put(table[:, j * 513 : (j + 1) * 513]) for j in range(4))
    assert torch.equal(got[:, : table.shape[1]], sbb.xla16(planes, put(idx), put(w)))


def test_dma_blend_asks_for_more_than_48_kb_and_launches(card):
    lib = tbuild.load("dma_blend")
    lib.jt_dma_blend_smem_bytes.argtypes = []
    lib.jt_dma_blend_smem_bytes.restype = ctypes.c_longlong
    assert lib.jt_dma_blend_smem_bytes() > 48 * 1024
    flat, idx, w, c_pad = _blend(card, 64)
    got = tdb.dma_blend(flat, idx, w, c_pad, tb=8)
    torch.cuda.synchronize()
    assert torch.equal(got, tdb.dma_blend_reference(flat, idx, w, c_pad, tb=8))


def test_dma_blend_launch_errors_are_reported(card):
    """A launch the card refuses returns its error code; the wrapper raises
    on any."""
    flat, idx, w, c_pad = _blend(card, 8)
    out = torch.empty((8, c_pad), device=card)
    for form in (tfs.DOUBLE, tfs.DEDUP):
        err = tdb._form_entry()(card.index, torch.cuda.current_stream(card).cuda_stream,
                                tdb._FORM_CODE[form], flat.data_ptr(), 710, c_pad,
                                idx.data_ptr(), w.data_ptr(), out.data_ptr(), 0)
        assert err != 0
        assert "invalid configuration" in tfs._cuda_error("dma_blend", err)


def test_dma_blend_refuses_a_misaligned_table(card):
    flat, idx, w, c_pad = _blend(card, 8)
    shifted = torch.empty(flat.numel() + 1, device=card)[1:]
    shifted.copy_(flat)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tdb.dma_blend(shifted, idx, w, c_pad, tb=8)
    with pytest.raises(ValueError, match="needs a row"):
        tdb.dma_blend(flat, idx[:0], w[:0], c_pad, tb=8)


# ---- launch A's forms and row 9's call path ------------------------------------

_GEO = dict(pad_len=1024, bins=513, fpb=128)
# (sources, blocks, n_dist or None for per-row distance): the main path's
# shapes, ragged counts, and 1-8 triples with selectors outside 1..n_dist-1
_FWD_CASES = [
    (256, 64, 1), (16, 256, None), (16, 256, 8), (1, 2048, None), (1, 12556, None),
    (1, 1, None), *((1, nb, None) for nb in (2, 3, 4, 5, 6, 7, 8, 9, 33, 65)), (4, 66, None),
    (3, 9, None), *((s, nb, n) for n in range(1, 9) for s, nb in ((4, 66), (2, 3))),
]


@pytest.mark.parametrize("sources,nb,n_dist", _FWD_CASES)
def test_launch_a_forms_are_the_tile_form_bit_for_bit(card, sources, nb, n_dist):
    ops = bench.forward_operands(sources, nb, card, seed=sources * 1000 + nb, n_dist=n_dist)
    forms = [tfs.FWD_TILE, tfs.FWD_PRODUCT] + ([tfs.FWD_FEW] if nb <= tfs.FEW_NB else [])
    tfs.reset_launches()
    xd = {f: tfs._forward_cuda(*ops, form=f, **_GEO) for f in forms}
    torch.cuda.synchronize()
    assert tfs.forward_launches == {f: int(f in forms) for f in tfs.forward_launches}
    for f in forms[1:]:
        assert torch.equal(xd[f][0], xd[tfs.FWD_TILE][0]), f
        assert torch.equal(xd[f][1], xd[tfs.FWD_TILE][1]), f
    want = tfs._forward_reference(*ops, **_GEO)
    peak = max(float(a.abs().max()) for a in want)
    for got, w in zip(xd[tfs.FWD_PRODUCT], want):
        assert float((got - w).abs().max()) <= 1e-6 * peak


def test_a_refused_few_block_launch_raises(card):
    ops = bench.forward_operands(1, tfs.FEW_NB + 1, card, seed=0)
    xd = [torch.empty((tfs.FEW_NB + 1, 513), device=card) for _ in range(2)]
    bases = [t.data_ptr() for t in (
        tfs.fft_ops.on_device(tfs.fft_ops._subblock_dft_matrices, 1024, 128, device=card)
        + tfs.fft_ops.on_device(tfs.fft_ops._sliding_twiddles, 1024, 128, device=card))]
    err = tfs._forward_entry((128, 1024))(
        card.index, torch.cuda.current_stream(card).cuda_stream, tfs._FWD_CODE[tfs.FWD_FEW],
        ops[0].data_ptr(), 1, tfs.FEW_NB + 1, *(t.data_ptr() for t in ops[2:5]), None, 0,
        *bases, *(t.data_ptr() for t in xd), None, None)   # no planes-form scratch
    assert err != 0


@pytest.mark.parametrize("nb", [1, 9, 10, 64])
def test_the_steps_take_launch_a_by_blocks(card_db, nb):
    fn, args, kw = bench.scene_step(card_db, "gather", 2, nb, torch.device("cuda", 0))
    tfs.reset_launches()
    fn(*args, **kw)
    torch.cuda.synchronize()
    want = tfs.FWD_FEW if nb <= tfs.FEW_NB else tfs.FWD_PRODUCT
    assert tfs.forward_launches == {f: int(f == want) for f in tfs.forward_launches}


def test_prod_wrapper_is_the_kernel_and_refuses_mixed_devices(card):
    xr, xi, gr, gi, _, _ = _planes(card, 256, 513, seed=5)
    got = tap.prod(xr, xi, gr, gi)
    out = [torch.empty_like(xr) for _ in range(2)]
    err = tap._lib().jt_prod(card.index, torch.cuda.current_stream(card).cuda_stream,
                             *(t.data_ptr() for t in (xr, xi, gr, gi, *out)), xr.numel())
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])
    with pytest.raises(ValueError, match="one device"):
        tap.prod(xr, xi, gr, gi.cpu())
    with pytest.raises(ValueError, match="gi: want contiguous"):
        tap.prod(xr, xi, gr, gi.double())


# ---- row 1's staged form and row 12's dedup form ------------------------------

@pytest.mark.parametrize("s,nb,radius_step", [
    (256, 64, 0.0), (256, 64, 0.05), (3, 9, 0.0), (4, 66, 0.0), (4, 66, 0.05), (1, 1, 0.0),
])
def test_row_1_staged_form_is_launch_b_bit_for_bit(card_db, s, nb, radius_step):
    """The bench shape with compact and per-row distance, and ragged counts
    whose 32-row tiles cross a source's end."""
    args, kw = _operands(card_db, radius_step, s, nb)
    one = tfs._cuda(tfs.fused_step_onehot_xfade, *args, form=tfs.LAUNCH_B, **kw)
    before = tfs.row1_forms[tfs.STAGED]
    staged = tfs._cuda(tfs.fused_step_onehot_xfade, *args, form=tfs.STAGED, **kw)
    torch.cuda.synchronize()
    assert tfs.row1_forms[tfs.STAGED] == before + 1
    assert torch.equal(one, staged)
    want = tfs.fused_step_onehot_xfade_reference(*args, **kw)
    assert float((staged - want).abs().max()) <= TOL


@pytest.mark.parametrize("case", ["outside", "many_distinct"])
def test_row_1_staged_form_on_ids_outside_and_many_distinct_rows(card_db, case):
    """Ids outside the table add nothing; more distinct table rows a tile
    than the form stages (random ids over 700 rows) read the table through
    L2: launch B's bits either way."""
    args, kw = _operands(card_db, 0.0, 4, 66)
    args = list(args)
    rng = np.random.default_rng(11)
    put = lambda a: torch.from_numpy(a).to(args[0].device)
    if case == "outside":
        u = args[4].shape[0]
        args[5] = args[5].clone()
        args[5][3, 1], args[5][17, 0], args[5][200, 2] = u + 2, -4, u
        args[7] = args[7].clone()
        args[7][1, 3] = u + 9
    else:
        args[4] = put(rng.standard_normal((700, args[4].shape[1])).astype(np.float32))
        args[5] = put(rng.integers(0, 700, args[5].shape).astype(np.int32))
        args[7] = put(rng.integers(0, 700, args[7].shape).astype(np.int32))
    one = tfs._cuda(tfs.fused_step_onehot_xfade, *args, form=tfs.LAUNCH_B, **kw)
    staged = tfs._cuda(tfs.fused_step_onehot_xfade, *args, form=tfs.STAGED, **kw)
    assert torch.equal(one, staged)


def test_row_1_takes_its_forms_by_rows(card_db):
    for s, nb in ((4, 16), (256, 64)):
        args, kw = _operands(card_db, 0.0, s, nb)
        form = tfs.pick_form("fused_step_onehot_xfade", s * nb)
        before = tfs.row1_forms[form]
        tfs.fused_step_onehot_xfade(*args, **kw)
        assert tfs.row1_forms[form] == before + 1


def test_a_refused_staged_launch_raises(card_db, monkeypatch):
    """The entry refuses a form it does not know and returns the error; the
    wrapper raises, and nothing falls back to launch B or the twin."""
    args, kw = _operands(card_db, 0.0)
    monkeypatch.setitem(tfs._FORM_CODE, tfs.STAGED, 7)
    tfs.reset_launches()
    with pytest.raises(RuntimeError, match="fused_step_onehot_xfade launch failed: CUDA error"):
        tfs._cuda(tfs.fused_step_onehot_xfade, *args, form=tfs.STAGED, **kw)
    assert sum(tfs.launches.values()) == 0


@pytest.mark.parametrize("r,c_pad", [
    (8448, 2176), (8448, 2052), (4096, 2052), (8447, 2176), (264, 2052), (33, 2176), (1, 2052),
])
def test_dedup_blend_is_the_double_form_and_blend_cat_bit_for_bit(card, r, c_pad):
    """The probe's shape, the render path's c = 2,052 and ragged row counts,
    on the shootout's ids."""
    idx, w = sbb.workload(r)
    table, table_pad = sbb.tables()
    tab = table_pad if c_pad == 2176 else table
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)
    flat, i_d, w_d = put(tab.reshape(-1)), put(idx), put(w)
    double = tdb._cuda(flat, i_d, w_d, c_pad, form=tfs.DOUBLE)
    before = tfs.blend_forms[tfs.DEDUP]
    dedup = tdb._cuda(flat, i_d, w_d, c_pad, form=tfs.DEDUP)
    torch.cuda.synchronize()
    assert tfs.blend_forms[tfs.DEDUP] == before + 1
    assert torch.equal(dedup, double)
    assert torch.equal(dedup, tfs.blend_cat(flat.view(-1, c_pad), i_d, w_d))


@pytest.mark.parametrize("c_pad", [2176, 2052])
def test_dedup_blend_on_ids_outside_the_table(card, c_pad):
    flat, idx, w, _ = _blend(card, 264, c_pad)
    idx = idx.clone()
    idx[3, 1], idx[5, 0], idx[17, 3], idx[263, 2] = 712, -4, 710, 10**6
    double = tdb._cuda(flat, idx, w, c_pad, form=tfs.DOUBLE)
    dedup = tdb._cuda(flat, idx, w, c_pad, form=tfs.DEDUP)
    assert torch.equal(dedup, double)
    assert torch.equal(dedup, tdb.dma_blend_reference(flat, idx, w, c_pad, tb=8))


@pytest.mark.parametrize("r", [100, 6403, 50693])
def test_dedup_blend_splits_a_tile_over_every_some_or_one_slice(card, r):
    """csrc/dma_blend.cu dedup_groups shares a tile's 17 column slices at c
    = 2,052 among min(17, ceil(1,584 / tiles)) CTAs: 100 rows (4 tiles) all
    17, 6,403 rows (201 tiles) 8, 50,693 rows (1,585 tiles) 1; each writes
    every slice once."""
    flat, idx, w, c_pad = _blend(card, r, 2052)
    got = tdb._cuda(flat, idx, w, c_pad, form=tfs.DEDUP)
    assert torch.equal(got, tdb._cuda(flat, idx, w, c_pad, form=tfs.DOUBLE))
    assert torch.equal(got, tdb.dma_blend_reference(flat, idx, w, c_pad, tb=1))


@pytest.mark.parametrize("r", [1, 16, 2048, 4096])
def test_blend_rows_on_the_card_is_blend_cat(card_db, r):
    """Rows 5-7's pre-blend on the render path's combined table: row 12,
    counted, with blend_cat's bits."""
    from jefferson_tpu_torch.convert import spectra_from_numpy
    from jefferson_tpu_torch.engine.renderer import cat_table

    dev = torch.device("cuda", 0)
    cat = cat_table(spectra_from_numpy(card_db.spectra, dev))
    idx, w = sbb.workload(r)
    i_d, w_d = torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)
    before = tfs.launches["dma_blend"]
    got = tdb.blend_rows(cat, i_d, w_d)
    torch.cuda.synchronize()
    assert tfs.launches["dma_blend"] == before + 1
    assert torch.equal(got, tfs.blend_cat(cat, i_d, w_d))
    assert torch.equal(tdb.blend_rows(cat, i_d.long(), w_d.double()), got)


@pytest.mark.parametrize("pad", [4096, 8192])
def test_blend_rows_on_the_card_at_the_wide_tables(card, pad):
    """Row 12 at pad 4096 and 8192 (tables of 4 x 2,049 and 4 x 4,097
    columns, 700 rows): both forms bit-equal to blend_cat at 1, 264 and
    4,096 rows, ids and weights random, some outside the table."""
    bins = pad // 2 + 1
    rng = np.random.default_rng(pad)
    table = torch.from_numpy(rng.standard_normal((700, 4 * bins)).astype(np.float32)).to(card)
    for r in (1, 264, 4096):
        idx = torch.from_numpy(rng.integers(-2, 702, (r, 4)).astype(np.int32)).to(card)
        w = torch.from_numpy(rng.random((r, 4)).astype(np.float32)).to(card)
        want = tfs.blend_cat(table, *tfs._in_table(idx, w, table.shape[0]))
        got = tdb.blend_rows(table, idx, w)
        double = tdb._cuda(table.reshape(-1), idx, w, 4 * bins, form=tfs.DOUBLE)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(double, want)


def test_blend_rows_on_the_card_refuses_what_it_does_not_take(card):
    flat, idx, w, c_pad = _blend(card, 8, 2052)
    table = flat.view(-1, c_pad)
    with pytest.raises(ValueError, match="one device"):
        tdb.blend_rows(table, idx.cpu(), w)
    with pytest.raises(ValueError, match="multiple of 4"):
        tdb.blend_rows(table[:, :2050].contiguous(), idx, w)
    with pytest.raises(ValueError, match="16-byte boundary"):
        shifted = torch.empty(table.numel() + 1, device=card)[1:].view(table.shape)
        tdb.blend_rows(shifted, idx, w)
    assert tdb.blend_rows(table, idx[:0], w[:0]).shape == (0, c_pad)


def test_a_refused_dedup_launch_raises(card):
    flat, idx, w, c_pad = _blend(card, 8, 2052)
    err = tdb._form_entry()(card.index, torch.cuda.current_stream(card).cuda_stream, 1,
                            flat.data_ptr(), 710, 2050, idx.data_ptr(), w.data_ptr(),
                            torch.empty((8, 2052), device=card).data_ptr(), 8)
    assert err != 0
    with pytest.raises(ValueError, match="want 'double' or 'dedup'"):
        tdb._cuda(flat, idx, w, c_pad, form="pair")


# ---- the CLI's path: -t 1 / -t 2, the fft backend, the reverb, the CLI ------

CARD_CPU_TOL = 1e-6  # the card's render vs the CPU port's: fp32 sums in other orders


def _noise(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2).astype(np.float32)


@pytest.mark.parametrize("ptype,backend,gate", [
    (0, "fft", 1e-6), (1, "matmul", 1e-6), (1, "fft", 2e-7), (2, "matmul", 5e-6),
])
def test_process_types_on_the_card_match_the_cpu_and_the_oracle(card_db, ptype, backend, gate):
    """-t 1, -t 2 and the fft backend on the card against the CPU port at
    CARD_CPU_TOL and the oracle at the JAX gates (2e-7 for -t 1 fft; TD
    against the gain-scaled oracle), a ragged last chunk included."""
    from jefferson_tpu_torch.config import ProcessType as P
    from jefferson_tpu_torch.trajectory.trajectory import CircularOrbit

    sig = _noise(60_000)
    pos = CircularOrbit(period_s=0.4, ele=10, r=1.0).sample(300, DEFAULT_CONFIG)
    card = Renderer(card_db, device="cuda", chunk_blocks=128, backend=backend)
    got = card.render(sig, pos, P(ptype))
    want = Renderer(card_db, device="cpu", chunk_blocks=128, backend=backend).render(
        sig, pos, P(ptype))
    assert np.abs(got - want).max() <= CARD_CPU_TOL
    td_gain = DEFAULT_CONFIG.source_gain if ptype == 2 else 1.0
    oracle = render_oracle(sig, card_db, [tuple(p) for p in pos], DEFAULT_CONFIG,
                           P(ptype + 3), td_gain=td_gain)
    assert np.abs(got - oracle).max() <= gate
    assert len(card.dispatch) == 3


def test_device_reverb_on_the_card(card_db):
    """The device reverb on the card against reverb_oracle and the CPU's
    device form; the streaming convolver keeps its state on the card."""
    from jefferson_tpu_torch.reverb.convolution import (
        StreamingConvolver, convolve_linear, reverb_oracle, reverb_reference,
    )

    dry, rng = _noise(44_100, 3), np.random.default_rng(4)
    ir = (rng.standard_normal(20_000) * np.exp(-np.arange(20_000) / 4000) * 0.1).astype(
        np.float32)
    got = reverb_reference(dry, ir, backend="device")
    assert np.abs(got - reverb_oracle(dry, ir)).max() < 5e-5
    assert np.abs(got - reverb_reference(dry, ir, backend="device", device="cpu")).max() < 5e-6
    lin = convolve_linear(dry, ir, backend="device")
    assert np.abs(lin - np.convolve(dry.astype(np.float64), ir)).max() < 5e-5
    conv = StreamingConvolver(ir, partition=1024)
    assert conv.device.type == "cuda"
    outs = [conv.process(dry[i : i + 1024]) for i in range(0, 20 * 1024, 1024)]
    for name in ("_hr", "_hi", "_ring_r", "_ring_i", "_overlap"):
        assert getattr(conv, name).is_cuda, name
    want = np.convolve(dry[: 20 * 1024].astype(np.float64), ir)[: 20 * 1024]
    assert np.abs(np.concatenate(outs) - want).max() < 5e-5


@pytest.mark.parametrize("ptype", range(6))
def test_cli_render_on_the_card(card_db, tmp_path, ptype):
    """One short CLI render per process type on the card (the default
    --device), against the oracle; -t 0 counts the CUDA steps."""
    from jefferson_tpu_torch.cli.main import main as cli_main
    from jefferson_tpu_torch.config import ProcessType as P
    from jefferson_tpu_torch.io.wavio import read_wav, write_wav
    from jefferson_tpu_torch.trajectory.trajectory import CircularOrbit

    sig = _noise(40_000, 5)
    write_wav(tmp_path / "in.wav", sig, 44100, bits=32, float_format=True)
    tfs.reset_launches()
    assert cli_main(["-i", str(tmp_path / "in.wav"), "-o", str(tmp_path / "out.wav"),
                     "-t", str(ptype), "--blocks", "200", "--trajectory", "orbit:period=0.5",
                     "--float", "--quiet"]) == 0
    got = read_wav(tmp_path / "out.wav")[0]
    pos = CircularOrbit(period_s=0.5).sample(200, DEFAULT_CONFIG)
    base = P(ptype % 3 + 3)
    td_gain = DEFAULT_CONFIG.source_gain if ptype == 2 else 1.0
    oracle = render_oracle(sig, card_db, [tuple(p) for p in pos], DEFAULT_CONFIG, base,
                           td_gain=td_gain)
    assert np.abs(got - oracle).max() <= (5e-6 if ptype == 2 else 1e-6)
    assert (sum(tfs.launches.values()) > 0) == (ptype == 0)


def test_irfft_on_the_card_drops_the_edge_bins_imaginary_parts(card_db):
    """cuFFT's C2R reads the imaginary parts of the DC and Nyquist bins;
    ops.fft.irfft zeroes them, so the card's inverse is numpy's."""
    from jefferson_tpu_torch.ops import fft as fft_ops

    rng = np.random.default_rng(9)
    x = (rng.standard_normal((64, 513)) + 1j * rng.standard_normal((64, 513))).astype(np.complex64)
    got = fft_ops.irfft(torch.from_numpy(x).cuda(), 1024).cpu().numpy()
    assert np.abs(got - np.fft.irfft(x, 1024)).max() <= 1e-6


# ---- the surfaces of ROADMAP item 8 on the card -------------------------------

@pytest.fixture(scope="module")
def card_daemon(card_db, tmp_path_factory):
    import threading

    from jefferson_tpu_torch.serve import RenderService, request, serve

    sock = tmp_path_factory.mktemp("card_serve") / "jt.sock"
    service = RenderService(chunk_blocks=2048)
    t = threading.Thread(target=serve, args=(sock, service), daemon=True)
    t.start()
    for _ in range(400):
        try:
            if request(sock, {"cmd": "ping"})["pong"]:
                break
        except OSError:
            time.sleep(0.05)
    yield sock, service
    request(sock, {"cmd": "shutdown"})
    t.join(timeout=15)


def test_daemon_render_on_the_card_is_the_renderers(card_db, card_daemon, tmp_path):
    """The daemon's render equals, bit for bit, an in-process
    Renderer(device="cuda") render of the same input and trajectory."""
    from jefferson_tpu_torch.cli.main import parse_trajectory
    from jefferson_tpu_torch.io.wavio import read_wav, read_wav_mono, write_wav
    from jefferson_tpu_torch.serve import request

    sock, _ = card_daemon
    sig = (np.random.default_rng(3).standard_normal(44100) * 0.2).astype(np.float32)
    write_wav(tmp_path / "in.wav", sig, 44100, bits=32, float_format=True)
    spec = "orbit:period=2,ele=10,r=1.2"
    resp = request(sock, {"cmd": "render", "input": str(tmp_path / "in.wav"),
                          "output": str(tmp_path / "o.wav"), "trajectory": spec,
                          "blocks": 3000, "float": True, "bits": 32})
    assert resp["ok"], resp
    got = read_wav(tmp_path / "o.wav")[0]
    pos = parse_trajectory(spec).sample(3000, DEFAULT_CONFIG)
    want = Renderer(card_db, device="cuda").render(read_wav_mono(tmp_path / "in.wav")[0], pos)
    np.testing.assert_array_equal(got, want)


def test_daemon_session_runs_on_a_stream_of_its_own(card_daemon, tmp_path, monkeypatch):
    """A live session's blocks run on a CUDA stream of the session's own,
    not the default stream a render's chunks queue on."""
    from jefferson_tpu_torch.engine import stream as stream_mod
    from jefferson_tpu_torch.io.wavio import read_wav, write_wav
    from jefferson_tpu_torch.serve import request

    sock, service = card_daemon
    seen = set()
    process = stream_mod.StreamingSpatializer.process_block

    def spy(self, block):
        seen.add(torch.cuda.current_stream(self.device).cuda_stream)
        return process(self, block)

    monkeypatch.setattr(stream_mod.StreamingSpatializer, "process_block", spy)
    write_wav(tmp_path / "in.wav", np.full(4000, 0.1, np.float32), 44100)
    sids = [request(sock, {"cmd": "stream_start", "input": str(tmp_path / "in.wav"),
                           "output": str(tmp_path / f"l{i}.wav"), "seconds": 0.2,
                           "paced": False})["session"] for i in range(2)]
    for sid in sids:
        for _ in range(1000):
            if not service._streams[sid]["thread"].is_alive():
                break
            time.sleep(0.01)
        stats = request(sock, {"cmd": "stream_stop", "session": sid})
        assert stats["ok"] and stats["blocks"] == 69, stats
    assert len(seen) == 2
    assert torch.cuda.default_stream().cuda_stream not in seen
    y = read_wav(tmp_path / "l0.wav")[0]
    assert y.shape == (69 * 128, 2) and np.isfinite(y).all()


def test_rt_on_the_card_matches_the_cpu(card_db, tmp_path):
    from jefferson_tpu_torch.io.wavio import read_wav, write_wav
    from jefferson_tpu_torch.rt.__main__ import main as rt_main

    sig = (np.random.default_rng(4).standard_normal(30000) * 0.2).astype(np.float32)
    write_wav(tmp_path / "in.wav", sig, 44100, bits=32, float_format=True)
    for device in ("cuda", "cpu"):
        assert rt_main(["-i", str(tmp_path / "in.wav"), "-o", str(tmp_path / f"{device}.wav"),
                        "--seconds", "1", "--device", device]) == 0
    got, want = (read_wav(tmp_path / f"{d}.wav")[0] for d in ("cuda", "cpu"))
    assert got.shape == want.shape == (345 * 128, 2)
    assert float(np.abs(got - want).max()) <= 1e-6


# ---- the differentiable path (diff/) -------------------------------------------


def _diff_probe(seed=42, n=9000):
    rng = np.random.default_rng(seed)
    sig = np.convolve(rng.standard_normal(n), np.hanning(16), mode="same")
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def test_diff_entry_points_refuse_a_cuda_device_without_a_card(monkeypatch):
    """``device="cuda"`` without a card raises; nothing falls back to the
    CPU.  Runs without a card too."""
    from jefferson_tpu_torch.diff.personalize import fit_database
    from jefferson_tpu_torch.diff.render import DifferentiableRenderer

    db = synthetic_database(DEFAULT_CONFIG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DifferentiableRenderer(db)
    with pytest.raises(RuntimeError, match="is_available"):
        DifferentiableRenderer(db, device="cuda:0")
    with pytest.raises(RuntimeError, match="is_available"):
        fit_database([(30.0, 0.0, db.hrirs[0, :, :128])], db, steps=1)


@pytest.mark.parametrize("nb", [8, 512])
def test_diff_render_spectra_and_gradients_on_the_card_match_the_cpu(card_db, nb):
    from jefferson_tpu_torch.diff.render import DifferentiableRenderer

    sig = _diff_probe(n=nb * 128)
    rng = np.random.default_rng(nb)
    pos = np.stack([rng.uniform(0, 360, nb), rng.uniform(-40, 90, nb), rng.uniform(0.3, 4, nb)],
                   -1).astype(np.float32)
    pos[:4] = [[40.0, 0.0, 1.0], [90.0, 90.0, 1.5], [10.0, -40.0, 0.5], [0.0, 20.0, 4.0]]
    out, grads = {}, {}
    for device in ("cuda", "cpu"):
        r = DifferentiableRenderer(card_db, device=device)
        xr, xi = r._forward(sig, nb)
        p = torch.tensor(pos, device=r.device, requires_grad=True)
        y = r.render_spectra(xr, xi, p)
        torch.sum(y ** 2).backward()
        out[device], grads[device] = y.detach().cpu().numpy(), p.grad.cpu().numpy()
    assert out["cuda"].shape == (nb, 128, 2)
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-6
    for col in range(3):
        g, w = grads["cuda"][:, col], grads["cpu"][:, col]
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), col


def test_diff_grid_chunk_on_the_card_matches_the_cpu(card_db):
    """One grid chunk (256 candidates x 12 blocks, batched) on the card."""
    from jefferson_tpu_torch.diff.render import DifferentiableRenderer, _Fit

    sig, b = _diff_probe(), 12
    true_pos = np.tile([62.0, 18.0, 1.3], (b, 1)).astype(np.float32)
    init = np.tile([40.0, 0.0, 1.0], (b, 1)).astype(np.float32)
    rng = np.random.default_rng(3)
    cand = np.stack([rng.uniform(0, 360, 256), rng.uniform(-40, 90, 256),
                     rng.uniform(0.25, 4, 256)], -1).astype(np.float32)
    got = {}
    for device in ("cuda", "cpu"):
        r = DifferentiableRenderer(card_db, device=device)
        target = r.render(sig, true_pos)
        got[device] = _Fit(r, sig, target, init, True).grid(cand)
    assert got["cuda"].shape == (256, b)
    assert np.abs(got["cuda"] - got["cpu"]).max() <= 1e-5 * np.abs(got["cpu"]).max()


def test_diff_fit_database_step_on_the_card_matches_the_cpu(card_db, monkeypatch):
    """One fit_database step: its loss and the gradients it steps with."""
    from jefferson_tpu_torch.diff.personalize import fit_database
    from jefferson_tpu_torch.hrtf.kemar import grid_position

    picks = np.random.default_rng(5).choice(710, size=24, replace=False)
    meas = [(grid_position(int(i))[1], grid_position(int(i))[0],
             card_db.hrirs[i, :, :128] * 1.1) for i in picks]
    grads = []
    step = torch.optim.Adam.step

    def logged(self, *a, **kw):
        grads.append([p.grad.cpu().numpy() for g in self.param_groups for p in g["params"]])
        return step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", logged)
    hist = {d: fit_database(meas, card_db, steps=1, device=d)[1] for d in ("cuda", "cpu")}
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-6)
    peak = max(np.abs(g).max() for g in grads[1])
    for g, w in zip(*grads):
        assert np.abs(g - w).max() <= 1e-5 * peak


MESH_CASES = ("dedup_fused_sparse", "onehot_shared", "onehot_shared_mix", "onehot_grouped",
              "gather_fused", "blk_mover")


def test_mesh_renders_in_two_gloo_ranks_on_the_card(card_db, tmp_path):
    """Two gloo ranks share the card (requested explicitly: NCCL refuses
    two ranks on one card): BatchRenderer on a src mesh and Renderer on a
    blk mesh, each rank's kernels on its shard, held to the unsharded card
    render (1e-7 per source, 1e-6 for the mixdown) with one collective a
    chunk."""
    from test_torch_parallel import CASES, _render, spawn_worker

    records, outputs = spawn_worker(tmp_path, n=2, device="cuda", backend="gloo",
                                    names=list(MESH_CASES))
    for name in MESH_CASES:
        mix = CASES[name][3].get("mix", False)
        want, r = _render(name, card_db, "cuda")
        assert np.abs(outputs[name] - want).max() <= (1e-6 if mix else 1e-7), name
        for rec in records:
            case = rec["cases"][name]
            chunks = len(case["dispatch"])
            assert case["collectives"] == ({"mix_all_reduce": chunks, "gather_rows": 0} if mix
                                           else {"mix_all_reduce": 0, "gather_rows": chunks})
            if CASES[name][0] == "batch":  # the blk mesh runs the unfused chunks
                assert sum(case["launches"].values()) >= chunks, (name, case["launches"])


def test_meshed_daemon_on_gloo_ranks_on_the_card(tmp_path):
    """serve --devices 2 --backend gloo (two ranks on cuda:0) against the
    meshless daemon in this process and the unsharded card renders:
    chip_smoke.py's check (``meshed_serve``) on a 1,024-block render and a
    4-source scene of 256 blocks."""
    import threading

    from jefferson_tpu_torch import serve as tserve
    from jefferson_tpu_torch.io.wavio import write_wav

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _smoke()
    cfg = DEFAULT_CONFIG
    src = tmp_path / "in.wav"
    noise = (np.random.default_rng(0).standard_normal(1024 * 128) * 0.2).astype(np.float32)
    write_wav(src, noise, cfg.sample_rate, bits=32, float_format=True)
    render_req = {"cmd": "render", "input": str(src), "output": str(tmp_path / "render.wav"),
                  "trajectory": smoke.SERVE_ORBIT, "blocks": 1024, "float": True, "bits": 32}
    scene_req = {"cmd": "scene", "blocks": 256, "float": True, "bits": 32, "scene": {"sources": [
        {"input": str(src), "trajectory": spec, "gain": smoke.SERVE_SCENE_GAIN}
        for spec in smoke.SERVE_SCENE[:smoke.MESH_SCENE_S]]}}
    sock = tmp_path / "meshless.sock"
    service = tserve.RenderService()
    threading.Thread(target=tserve.serve, args=(sock, service), daemon=True).start()
    for _ in range(400):
        if sock.exists():
            break
        time.sleep(0.05)
    try:
        assert tserve.request(sock, render_req)["ok"]
        assert tserve.request(sock, {**scene_req, "output": str(tmp_path / "scene4.wav")})["ok"]
    finally:
        tserve.request(sock, {"cmd": "shutdown"})
    launched = smoke.meshed_serve(cfg, tmp_path, render_req, scene_req)
    assert launched is not None and sum(launched.values()) >= 2


def test_mesh_nccl_refuses_two_ranks_on_one_card(card_db, monkeypatch):
    from jefferson_tpu_torch.parallel import mesh as pm

    if torch.cuda.device_count() > 1:
        pytest.skip("two ranks get a card each on this host")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one card.*backend='gloo'"):
        pm.init_world("nccl", device="cuda")


# ---- every block and transform size the JAX package runs ------------------

def _smoke():
    """chip_smoke.py as a module."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# phase geometry's table (name -> (fpb, HRIR taps)) and fpb 2 (EngineConfig's
# least block, Q 512): too many blocks for a whole render in the smoke, held here
# f2 (Q 512) and f4t2048 (fpb 4 under pad 4096: Q 1,024, launch A's ring form
# cycling its shared-memory ring 32 times) beside the smoke's
GEOMETRIES = {**_smoke().GEOMETRIES, "f2": (2, 512), "f4t2048": (4, 2048)}
_geo_dbs = {}


def _geo_db(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if name not in _geo_dbs:
        from jefferson_tpu_torch.config import EngineConfig

        fpb, taps = GEOMETRIES[name]
        _geo_dbs[name] = synthetic_database(EngineConfig(frames_per_buffer=fpb, hrtf_len=taps))
    return _geo_dbs[name]


def _held_to_twin(fn, args, kw, forms, rows, fpb):
    """Every named form of a step against its twin, and the forms bit-equal."""
    twin = getattr(tfa if fn is tfa.fused_apply_xfade else tfs, fn.__name__ + "_reference")
    got = [tfs._cuda(fn, *args, form=f, **kw) for f in forms]
    torch.cuda.synchronize()
    want = twin(*args, **kw)
    for g in got:
        assert g.shape == (rows, 2 * fpb)
        assert float((g - want).abs().max()) <= TOL
        assert torch.equal(g, got[0])


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometry_library_reports_the_forms_the_wrappers_pick_among(name):
    db = _geo_db(name)
    cfg = db.config
    for lib in tbuild.GEOMETRIC:
        assert tfs.library_geometry(lib, cfg.frames_per_buffer, cfg.pad_len) == \
            tfs.geometry_forms(cfg.frames_per_buffer, cfg.pad_len)
        path = tbuild.library_path(lib, geometry=(cfg.frames_per_buffer, cfg.pad_len))
        assert path.exists() and f"-f{cfg.frames_per_buffer}p{cfg.pad_len}-" in path.name


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometry_kernel_forms_match_their_twins(name):
    """Rows 1-8 and launch A in every form the geometry's library has
    (rows 7 and 8's apply-only forms at a history of partial blocks), at
    8 and 264 rows, against their twins and each other."""
    db = _geo_db(name)
    cfg = db.config
    fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
    forms = tfs.geometry_forms(fpb, pad)
    dev = torch.device("cuda", 0)
    tail = [tfs.LAUNCH_B] + ([tfs.SPLIT] if forms.split else [])
    geo = dict(pad_len=pad, bins=bins, fpb=fpb)
    if forms.q:
        for s_, nb, nd in ((3, 88, None), (2, 4, 3), (1, 1, None)):
            ops = bench.forward_operands(s_, nb, dev, n_dist=nd, config=cfg)
            names = ([tfs.FWD_TILE] if forms.tile else []) + (
                [tfs.FWD_PRODUCT] if forms.product else []) + (
                [tfs.FWD_FEW] if nb <= forms.few_nb else []) + [tfs.FWD_PLANES] + (
                [tfs.FWD_RING] if forms.ring else [])
            got = [tfs._forward_cuda(*ops, form=f, **geo) for f in names]
            want = tfs._forward_reference(*ops, **geo)
            peak = max(float(w.abs().max()) for w in want)
            for xd in got:
                assert all(torch.equal(a, b) for a, b in zip(xd, got[0]))
                assert max(float((a - w).abs().max()) for a, w in zip(xd, want)) <= 1e-6 * peak
        args, kw = bench.step_operands(bench.build_workload(db, 2, 4, dev), cfg)
        _held_to_twin(tfs.fused_step_onehot_xfade, args, kw, [tfs.LAUNCH_B], 8, fpb)
        for form in ("onehot", "grouped", "gather", "gather_noxf"):
            fn, args, kw = bench.stream_step(db, form, 264, dev, tb=88, group_tiles=1, xf_every=5)
            _held_to_twin(fn, args, kw, tail, 264, fpb)
        for form in ("grouped", "gather", "gather_noxf"):
            groups = {"group_sources": 1} if form == "grouped" else {}
            fn, args, kw = bench.scene_step(db, form, 4, 66, dev, xf_every=5, **groups)
            _held_to_twin(fn, args, kw, tail, 264, fpb)
    for form in ("apply", "apply_noxf"):
        fn, args, kw = bench.scene_step(db, form, 2, 132, dev, xf_every=5)
        _held_to_twin(fn, args, kw, tail, 264, fpb)
    row8 = tail + ([tsp.CLUSTER] if forms.cluster else [])
    for rows in (1, 8, 264):
        table, fwd, br, xf = bench.spatializer_step(db, rows, dev)
        if forms.q:
            xd = tfs._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
        else:
            from jefferson_tpu_torch.engine.stream import _window_xd

            xd = _window_xd(fwd[0].unfold(0, pad, fpb), *fwd[1:], cfg)
        got = [tsp._cuda(dev, rows, table, br, xf, *xd, None, form=f, **geo) for f in row8]
        want = tsp.fused_apply_reference(table, *xd, *br, xf, bins=bins, fpb=fpb)
        for g in got:
            assert float((g - want).abs().max()) <= TOL and torch.equal(g, got[0])
        if forms.q:
            y = tsp.fused_forward_apply(table, *fwd, *br, xf, **geo)
            assert float((y - want).abs().max()) <= TOL


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometry_renders_on_the_card_match_the_twins(name):
    """A short render of each engine on the card against the same render on
    the CPU (the twins), with the launches the dispatch names."""
    db = _geo_db(name)
    cfg = db.config
    fpb = cfg.frames_per_buffer
    sig = (np.random.default_rng(3).standard_normal(96 * fpb) * 0.2).astype(np.float32)
    pos = bench.helix_positions(96, cfg=cfg)
    tfs.reset_launches()
    got = Renderer(db, device="cuda", chunk_blocks=32).render(sig, pos)
    assert sum(tfs.launches.values()) >= 3
    want = Renderer(db, device="cpu", chunk_blocks=32).render(sig, pos)
    assert float(np.abs(got - want).max()) <= 1e-6
    got = render_scan(sig, db, pos, cfg, device="cuda", chunk_blocks=40)
    assert float(np.abs(got - render_scan(sig, db, pos, cfg, device="cpu")).max()) <= 1e-6
    card, cpu = (StreamingSpatializer(db, device=d) for d in ("cuda", "cpu"))
    for b in range(12):
        for sp in (card, cpu):
            sp.set_position(azi=30.0 * (b // 3), ele=5.0, r=1.0)
        blk = sig[b * fpb:(b + 1) * fpb]
        assert float(np.abs(card.process_block(blk) - cpu.process_block(blk)).max()) <= 1e-6


@pytest.mark.parametrize("fpb,taps", [(16, 512), (128, 3969)])
def test_geometry_outside_the_envelope_raises_before_any_launch(fpb, taps):
    """The geometries the card once refused (fpb 16, pad 4096) build and
    run; a geometry past the grid's y (launch B's t-tiles) raises before any
    launch, naming that resource."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jefferson_tpu_torch.config import EngineConfig

    cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
    db = synthetic_database(cfg)
    sig = (np.random.default_rng(4).standard_normal(40 * fpb) * 0.2).astype(np.float32)
    pos = bench.helix_positions(40, cfg=cfg)
    tfs.reset_launches()
    got = Renderer(db, device="cuda", chunk_blocks=16).render(sig, pos)
    assert sum(tfs.launches.values()) >= 3
    want = Renderer(db, device="cpu", chunk_blocks=16).render(sig, pos)
    assert float(np.abs(got - want).max()) <= 1e-6
    big = dataclasses.replace(db, config=EngineConfig(frames_per_buffer=1 << 24, hrtf_len=taps))
    tfs.reset_launches()
    for make in (lambda: Renderer(big, device="cuda"),
                 lambda: StreamingSpatializer(big, device="cuda")):
        with pytest.raises(ValueError, match="t-tiles of 128 columns exceed the 65535 CTAs"):
            make()
    assert not any(tfs.launches.values())


# ---- launch B's tile fitted to blocks below 128 columns ---------------------

@pytest.mark.parametrize("rows", [8, 264, 4096])
@pytest.mark.parametrize("name", _FIT)
def test_fitted_tile_forms_are_bit_equal_and_match_their_twins(name, rows):
    """Rows 1-7 at the geometries whose tile fits the block, with and
    without the crossfade: launch B and the split form torch.equal, both
    within TOL of the twin; at 264 rows segment and group ends fall inside
    tiles and the brackets repeat one id.  The libraries report the tile's
    width."""
    db = _geo_db(name)
    fpb, pad = db.config.frames_per_buffer, db.config.pad_len
    forms = tfs.geometry_forms(fpb, pad)
    assert forms.tile_cols == fpb
    for lib in tbuild.GEOMETRIC:
        assert tfs.library_geometry(lib, fpb, pad).tile_cols == fpb
    tail = [tfs.LAUNCH_B] + ([tfs.SPLIT] if forms.split else [])
    dev = torch.device("cuda", 0)
    s_, nb = _SCENE_SHAPES[rows]
    args, kw = bench.step_operands(bench.build_workload(db, s_, nb, dev), db.config)
    _fit_forms(tfs.fused_step_onehot_xfade, args, kw, [tfs.LAUNCH_B], rows, fpb)
    for form in ("apply", "apply_noxf", "gather", "gather_noxf", "grouped"):
        groups = {"group_sources": _SPLIT_GROUPS[rows]} if form == "grouped" else {}
        fn, args, kw = bench.scene_step(db, form, s_, nb, dev, xf_every=5,
                                        duplicate=rows == 264, **groups)
        _fit_forms(fn, args, kw, tail, rows, fpb)
    tb, gt = _WIDE_GROUPING[rows]
    for form in bench.STREAM_FORMS:
        fn, args, kw = bench.stream_step(db, form, rows, dev, tb=tb, group_tiles=gt,
                                         radius_step=0.01, xf_every=5)
        _fit_forms(fn, args, kw, tail, rows, fpb)


# ---- launch A's ring form past Q 16 ------------------------------------------

_RING = ("f16", "f4", "f2", "f4t2048", "f128t2048")
# (sources, blocks, n_dist or None): 16 outputs a thread at 16 x 64, 16 x
# 256, 1 x 2,048 and 5 x 200 (its last run of 64 blocks ragged), 4 at 3 x 88
# (ragged), 1 at the live block and at 2 x 4 with 3 triples
_RING_SHAPES = [(3, 88, None), (2, 4, 3), (1, 1, None), (16, 64, None), (16, 256, None),
                (16, 256, 8), (1, 2048, None), (5, 200, None)]


@pytest.mark.parametrize("sources,nb,n_dist", _RING_SHAPES)
@pytest.mark.parametrize("name", _RING)
def test_launch_a_ring_form_is_the_planes_form_bit_for_bit(name, sources, nb, n_dist):
    """The ring form torch.equal to the two-launch planes form in both XD
    planes, within 1e-6 of the twin's peak, and counted as itself."""
    db = _geo_db(name)
    cfg = db.config
    geo = dict(pad_len=cfg.pad_len, bins=cfg.num_bins, fpb=cfg.frames_per_buffer)
    assert tfs.geometry_forms(cfg.frames_per_buffer, cfg.pad_len).ring
    ops = bench.forward_operands(sources, nb, torch.device("cuda", 0), seed=sources + nb,
                                 n_dist=n_dist, config=cfg)
    tfs.reset_launches()
    ring = tfs._forward_cuda(*ops, form=tfs.FWD_RING, **geo)
    planes = tfs._forward_cuda(*ops, form=tfs.FWD_PLANES, **geo)
    torch.cuda.synchronize()
    assert tfs.forward_launches == {f: int(f in (tfs.FWD_RING, tfs.FWD_PLANES))
                                    for f in tfs.forward_launches}
    assert all(torch.equal(a, b) for a, b in zip(ring, planes))
    want = tfs._forward_reference(*ops, **geo)
    peak = max(float(w.abs().max()) for w in want)
    assert max(float((a - w).abs().max()) for a, w in zip(ring, want)) <= 1e-6 * peak


@pytest.mark.parametrize("name", ["f16", "f4"])
def test_the_planes_forms_two_launches_apart_are_the_planes_form(name):
    """The sub-block DFTs, then the twiddle sums from them, launched apart
    (chip_smoke.py times each so): the planes form's XD."""
    db = _geo_db(name)
    cfg = db.config
    geo = dict(pad_len=cfg.pad_len, bins=cfg.num_bins, fpb=cfg.frames_per_buffer)
    dev = torch.device("cuda", 0)
    ops = bench.forward_operands(4, 66, dev, config=cfg)
    shape = (4 * (66 + cfg.pad_len // cfg.frames_per_buffer - 1), cfg.num_bins)
    scratch = tuple(torch.empty(shape, device=dev) for _ in range(2))
    tfs._forward_cuda(*ops, form=tfs.FWD_PLANES, part=tfs.PLANES_DFT, scratch=scratch, **geo)
    got = tfs._forward_cuda(*ops, form=tfs.FWD_PLANES, part=tfs.PLANES_SUM, scratch=scratch,
                            **geo)
    want = tfs._forward_cuda(*ops, form=tfs.FWD_PLANES, **geo)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["f16", "f4", "f2", "f4t2048"])
def test_the_steps_take_launch_a_in_the_ring_form(name):
    """Rows 1-6 and row 8's forward form where launch A takes the ring form:
    each within TOL of its twin (row 8 ROW8_TOL), launch A counted in the
    ring form once a step."""
    db = _geo_db(name)
    cfg = db.config
    fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
    geo = dict(pad_len=pad, bins=bins, fpb=fpb)
    dev = torch.device("cuda", 0)
    assert tfs.forward_form(66, fpb, pad) == tfs.FWD_RING
    tfs.reset_launches()
    steps = 0
    args, kw = bench.step_operands(bench.build_workload(db, 4, 66, dev), cfg)
    _held_to_twin(tfs.fused_step_onehot_xfade, args, kw, [tfs.LAUNCH_B], 264, fpb)
    steps += 1
    tail = [tfs.LAUNCH_B] + ([tfs.SPLIT] if tfs.geometry_forms(fpb, pad).split else [])
    for form in ("onehot", "grouped", "gather", "gather_noxf"):
        fn, args, kw = bench.stream_step(db, form, 264, dev, tb=88, group_tiles=1, xf_every=5)
        _held_to_twin(fn, args, kw, tail, 264, fpb)
        steps += len(tail)
    for form in ("grouped", "gather", "gather_noxf"):
        groups = {"group_sources": 1} if form == "grouped" else {}
        fn, args, kw = bench.scene_step(db, form, 4, 66, dev, xf_every=5, **groups)
        _held_to_twin(fn, args, kw, tail, 264, fpb)
        steps += len(tail)
    table, fwd, br, xf = bench.spatializer_step(db, 264, dev)
    y = tsp.fused_forward_apply(table, *fwd, *br, xf, **geo)
    want = tsp.fused_forward_apply_reference(table, *fwd, *br, xf, **geo)
    assert float((y - want).abs().max()) <= ROW8_TOL
    steps += 1
    torch.cuda.synchronize()
    assert tfs.forward_launches == {f: steps if f == tfs.FWD_RING else 0
                                    for f in tfs.forward_launches}


def test_the_steps_keep_the_planes_form_past_the_ring_forms_blocks():
    """fpb 64 under pad 8192 (Q 128, no product form, past RING_MAX_FPB):
    a step of 2 sources x 8 blocks takes launch A's ring form (ring_pays)
    and row 8's one source of 16 rows the planes form with its scratch,
    each within its tolerance of the twin; the two forms give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jefferson_tpu_torch.config import EngineConfig

    cfg = EngineConfig(frames_per_buffer=64, hrtf_len=4096)
    db = synthetic_database(cfg)
    fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
    assert (pad, fpb > tfs.RING_MAX_FPB) == (8192, True)
    assert tfs.ring_pays(2, 8, fpb, pad) and not tfs.ring_pays(1, 16, fpb, pad)
    dev = torch.device("cuda", 0)
    geo = dict(pad_len=pad, bins=bins, fpb=fpb)
    fn, args, kw = bench.scene_step(db, "gather", 2, 8, dev, xf_every=5)
    tfs.reset_launches()
    _held_to_twin(fn, args, kw, [tfs.LAUNCH_B], 16, fpb)
    assert tfs.forward_launches == {f: int(f == tfs.FWD_RING) for f in tfs.forward_launches}
    table, fwd, br, xf = bench.spatializer_step(db, 16, dev)
    tfs.reset_launches()
    y = tsp.fused_forward_apply(table, *fwd, *br, xf, **geo)
    want = tsp.fused_forward_apply_reference(table, *fwd, *br, xf, **geo)
    torch.cuda.synchronize()
    assert float((y - want).abs().max()) <= ROW8_TOL
    assert tfs.forward_launches == {f: int(f == tfs.FWD_PLANES) for f in tfs.forward_launches}
    ops = bench.forward_operands(2, 8, dev, config=cfg)
    ring = tfs._forward_cuda(*ops, form=tfs.FWD_RING, **geo)
    planes = tfs._forward_cuda(*ops, form=tfs.FWD_PLANES, **geo)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ring, planes))
