"""The CUDA step on a card: against its plain twin, inside the renderer, and
its operand checks.  Every test needs a CUDA device and skips without one.

This file imports no jax, so a machine without jax runs it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from jefferson_tpu_torch import bench
from jefferson_tpu_torch.config import DEFAULT_CONFIG
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.engine.stream import StreamingSpatializer, render_scan
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.kernels import fused_apply as tfa
from jefferson_tpu_torch.kernels import fused_spatializer as tsp
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.oracle.reference import render_oracle

pytestmark = pytest.mark.cuda

TOL = 5e-7  # kernel vs twin: fp32 DFT sums in another order


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
    with pytest.raises(ValueError, match="built for fpb=128"):
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
    assert sum(tfs.launches.values()) == len(card.dispatch)
    cpu = Renderer(card_db, device="cpu", chunk_blocks=cb, **opts)
    want = cpu.render(sig, pos)
    assert card.dispatch == cpu.dispatch
    assert np.abs(got - want).max() <= TOL


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
    with pytest.raises(ValueError, match="built for fpb=128"):
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
    assert sum(tfs.launches.values()) == len(card.dispatch)
    cpu = BatchRenderer(card_db, device="cpu", chunk_blocks=cb, **opts)
    want = cpu.render(sig, pos)
    assert card.dispatch == cpu.dispatch
    assert np.abs(got - want).max() <= TOL


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
