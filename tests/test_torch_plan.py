"""The port's host planning, pinned bit-for-bit to the JAX package's.

``jefferson_tpu.engine.plan`` imports jax, so the port keeps NumPy copies of
the planning functions the batched render uses; every copy must give the
same arrays as the original on the same inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jefferson_tpu import DEFAULT_CONFIG, EngineConfig
from jefferson_tpu.engine import batch as jbatch
from jefferson_tpu.engine import plan as jplan
from jefferson_tpu.engine import renderer as jrenderer
from jefferson_tpu.trajectory.trajectory import CircularOrbit, StaticPosition
from jefferson_tpu_torch.engine import batch as tbatch
from jefferson_tpu_torch.engine import plan as tplan
from jefferson_tpu_torch.engine import renderer as trenderer

torch.set_num_threads(1)


def _positions(kind: str, blocks: int, cfg=DEFAULT_CONFIG, i: int = 0):
    if kind == "orbit":
        return CircularOrbit(period_s=0.4 + 0.01 * i, ele=5 + i, r=1.0 + 0.1 * i).sample(blocks, cfg)
    if kind == "static":
        return StaticPosition(azi=25 * i, ele=10, r=0.6).sample(blocks, cfg)
    rng = np.random.default_rng(i)  # scattered: azimuth and radius jump every block
    return np.stack([rng.uniform(-30, 400, blocks), rng.uniform(-45, 95, blocks),
                     rng.uniform(0.05, 3.0, blocks)], axis=1)


def _assert_plans_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("kind", ["orbit", "static", "scattered"])
@pytest.mark.parametrize("initial_old", [(0.0, 0.0), None, (33.4, -12.6)])
def test_make_plan_is_bit_equal(kind, initial_old):
    pos = _positions(kind, 40)
    _assert_plans_equal(tplan.make_plan(pos, DEFAULT_CONFIG, initial_old),
                        jplan.make_plan(pos, DEFAULT_CONFIG, initial_old))


def test_make_plan_rejects_what_the_original_rejects():
    for bad in (np.zeros((4, 2)), np.zeros((0, 3))):
        with pytest.raises(ValueError):
            jplan.make_plan(bad)
        with pytest.raises(ValueError):
            tplan.make_plan(bad)


@pytest.mark.parametrize("pad_b", [0, 1, 7])
def test_pad_plan_is_bit_equal(pad_b):
    pos = _positions("orbit", 13)
    _assert_plans_equal(tplan.pad_plan(tplan.make_plan(pos), pad_b),
                        jplan.pad_plan(jplan.make_plan(pos), pad_b))


@pytest.mark.parametrize("u_pad", [None, 64])
def test_compact_filter_ids_is_bit_equal(u_pad):
    plans = [jplan.make_plan(_positions("orbit", 24, i=i)) for i in range(3)]
    idx_old = np.stack([p.idx_old for p in plans])
    idx_last = np.stack([p.idx_new[-1] for p in plans])
    got = tplan.compact_filter_ids(idx_old, idx_last, u_pad=u_pad)
    want = jplan.compact_filter_ids(idx_old, idx_last, u_pad=u_pad)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    with pytest.raises(ValueError, match="exceed the bucket"):
        tplan.compact_filter_ids(idx_old, idx_last, u_pad=8)


def test_dedup_rows_is_bit_equal():
    p = jplan.make_plan(_positions("orbit", 60))
    idx = np.concatenate([p.idx_new, p.idx_new[:20]])
    w = np.concatenate([p.w_new, p.w_new[:20]])
    for g, want in zip(tplan.dedup_rows(idx, w), jplan.dedup_rows(idx, w)):
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("n", [100, 3 * 128, 5 * 128 + 77])
def test_fed_stream_is_bit_equal(n):
    sig = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(tplan.fed_stream(sig, 4), jplan.fed_stream(sig, 4))
    for bad in (np.zeros((2, 2), np.float32), np.zeros(0, np.float32)):
        with pytest.raises(ValueError):
            tplan.fed_stream(bad, 4)


@pytest.mark.parametrize("radius_step", [0.0, 0.05])
@pytest.mark.parametrize("cap", [None, 2])
def test_dedup_distance_is_bit_equal(radius_step, cap):
    plans = [jplan.make_plan(CircularOrbit(period_s=0.5, ele=5, r=1.0 + i * radius_step)
                             .sample(16, DEFAULT_CONFIG)) for i in range(4)]
    cat = [np.concatenate([getattr(p, a) for p in plans]) for a in ("u_hi", "u_lo", "inv_frac")]
    got, want = trenderer.dedup_distance(*cat, cap=cap), jrenderer.dedup_distance(*cat, cap=cap)
    if want is None:
        assert got is None
        return
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_dedup_distance_empty_and_scattered():
    empty = np.zeros(0, np.float32)
    assert trenderer.dedup_distance(empty, empty, empty) is None
    p = jplan.make_plan(_positions("scattered", 30))
    assert trenderer.dedup_distance(p.u_hi, p.u_lo, p.inv_frac) is None
    assert jrenderer.dedup_distance(p.u_hi, p.u_lo, p.inv_frac) is None


@pytest.mark.parametrize("b,seg,max_tb", [
    (1024, 64, 256), (64, 16, 256), (48, 16, 256), (96, 32, 64), (512, 512, 256),
    (300, 300, 256), (36, 12, 256), (24, 3, 256), (0, 8, 256), (40, 16, 256), (64, 8, 8),
])
def test_pick_fused_tile_is_equal(b, seg, max_tb):
    assert trenderer.pick_fused_tile(b, seg, max_tb) == jrenderer.pick_fused_tile(b, seg, max_tb)


@pytest.mark.parametrize("kind,s,blocks", [
    ("orbit", 4, 300), ("static", 8, 700), ("static", 64, 300), ("orbit", 2, 1), ("static", 0, 5),
])
@pytest.mark.parametrize("fused", [True, False])
def test_auto_chunk_is_equal(kind, s, blocks, fused):
    plans = [tplan.make_plan(_positions(kind, blocks, i=i)) for i in range(s)]
    assert tbatch._auto_chunk(s, blocks, plans, fused) == jbatch._auto_chunk(s, blocks, plans, fused)


@pytest.mark.parametrize("group", [None, 1, 2])
def test_group_bucket_is_equal(group):
    plans = [tplan.make_plan(_positions("scattered", 12, i=i)) for i in range(4)]
    io = np.stack([p.idx_old for p in plans])
    il = np.stack([p.idx_new[-1] for p in plans])
    assert tbatch._group_bucket(io, il, group) == jbatch._group_bucket(io, il, group)


@pytest.mark.parametrize("kind,s,blocks,cb", [
    ("orbit", 4, 48, 16), ("orbit", 3, 40, 32), ("scattered", 8, 32, 16), ("scattered", 2, 64, 64),
    ("movers", 8, 32, 16), ("movers", 4, 48, 24),
])
@pytest.mark.parametrize("max_u", [256, 32, 16])
def test_plan_batch_onehot_shared_branch_is_equal(kind, s, blocks, cb, max_u, monkeypatch):
    """The port's render-wide one-hot plan is the JAX planner's: ('shared',
    u_pad), ('grouped', group sources, u_pad) or None."""
    import jefferson_tpu.pallas.fused_step as jfs

    from jefferson_tpu_torch.kernels import fused_step as tfs

    monkeypatch.setattr(jfs, "MAX_ONEHOT_U", max_u)
    monkeypatch.setattr(tfs, "MAX_ONEHOT_U", max_u)
    if kind == "movers":
        from jefferson_tpu_torch.bench import scene_mover_positions

        pos = scene_mover_positions(s, blocks)
        plans = [tplan.make_plan(p) for p in pos]
    else:
        plans = [tplan.make_plan(_positions(kind, blocks, i=i)) for i in range(s)]
    for s_local in {s, s // 2}:
        got = tbatch._plan_batch_onehot(plans, blocks, cb, s_local)
        assert got == jbatch._plan_batch_onehot(plans, blocks, cb, s_local)
        io = np.stack([p.idx_old[:cb] for p in plans])
        il = np.stack([p.idx_new[cb - 1] for p in plans])
        assert (tbatch._plan_source_groups(io, il, s_local, 1)
                == jbatch._plan_source_groups(io, il, s_local, 1))


def test_hold_scene_test_matches_the_jax_dedup_decision():
    """``_plan_dedup`` takes the JAX BatchRenderer's dedup decision (batch.py
    render: 'u_pad * 2 > s * (cb + 1)' declines), with its chunks."""
    cfg = DEFAULT_CONFIG
    static = [tplan.make_plan(_positions("static", 32, i=i)) for i in range(4)]
    movers = [tplan.make_plan(CircularOrbit(period_s=0.4 + 0.01 * i, ele=1 + 2 * i, r=1.0)
                              .sample(32, cfg)) for i in range(4)]
    chunks, u_pad = tbatch._plan_dedup(static, 32, 16)
    assert u_pad == 8 and len(chunks) == 2
    for start, (uniq_idx, uniq_w, inv) in zip((0, 16), chunks):
        assert inv.shape == (4, 17)
        ext = np.concatenate([np.stack([p.idx_old[start : start + 1] for p in static]),
                              np.stack([p.idx_new[start : start + 16] for p in static])], axis=1)
        np.testing.assert_array_equal(uniq_idx[inv], ext)
    assert tbatch._plan_dedup(movers, 32, 16) is None
    # a single chunk padded far past its blocks holds its last position
    assert tbatch._plan_dedup([tbatch.pad_plan(p, 224) for p in movers], 256, 256) is not None


def test_compact_filter_ids_grouped_sources_is_bit_equal():
    from jefferson_tpu_torch.bench import scene_mover_positions

    plans = [jplan.make_plan(p) for p in scene_mover_positions(8, 24)]
    io = np.stack([p.idx_old for p in plans])
    il = np.stack([p.idx_new[-1] for p in plans])
    for group, u_pad in ((2, 64), (4, 128), (8, 256)):
        got = tplan.compact_filter_ids_grouped_sources(io, il, group, u_pad)
        want = jplan.compact_filter_ids_grouped_sources(io, il, group, u_pad)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="exceed the bucket"):
        tplan.compact_filter_ids_grouped_sources(io, il, 2, 8)
    with pytest.raises(ValueError, match="groups of 3"):
        tplan.compact_filter_ids_grouped_sources(io, il, 3, 64)


def test_scene_builders_are_the_sweep_gates():
    """The bench's scenes are ``jefferson_tpu.bench.sweep``'s, and the
    signals are the scene gate's rotated copies."""
    from jefferson_tpu.bench import sweep

    from jefferson_tpu_torch import bench

    np.testing.assert_array_equal(bench.scene_hold_positions(16, 700),
                                  sweep.scene_hold_positions(16, 700))
    np.testing.assert_array_equal(bench.scene_hold_positions(5, 90, 20),
                                  sweep.scene_hold_positions(5, 90, 20))
    np.testing.assert_array_equal(bench.scene_mover_positions(16, 700),
                                  sweep.scene_mover_positions(16, 700))
    sig = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    got = bench.scene_signals(sig, 3, 40)
    n = 40 * 128
    base = np.resize(sig, n)
    np.testing.assert_array_equal(got, np.stack([np.roll(base, -(s * 7919 * 128) % n)
                                                 for s in range(3)]))


def test_unaligned_geometry_plan_copies_stay_equal():
    cfg = EngineConfig(frames_per_buffer=96, hrtf_len=256)
    pos = _positions("orbit", 9, cfg)
    _assert_plans_equal(tplan.make_plan(pos, cfg), jplan.make_plan(pos, cfg))


def _mover(blocks: int):
    """The sweep gate's mover, ``jefferson_tpu.bench.sweep.mover_positions``."""
    from jefferson_tpu.bench.sweep import mover_positions

    return mover_positions(blocks)


@pytest.mark.parametrize("b,group,tb,u_pad", [
    (64, 32, 16, 64), (64, 64, 16, 128), (96, 32, 8, 64), (48, 16, 16, 32),
])
def test_compact_filter_ids_grouped_is_bit_equal(b, group, tb, u_pad):
    p = jplan.make_plan(_mover(b))
    got = tplan.compact_filter_ids_grouped(p.idx_old, p.idx_new[-1:], group, tb, u_pad)
    want = jplan.compact_filter_ids_grouped(p.idx_old, p.idx_new[-1:], group, tb, u_pad)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="exceed the bucket"):
        tplan.compact_filter_ids_grouped(p.idx_old, p.idx_new[-1:], group, tb, 8)


def test_bench_mover_positions_is_the_sweep_gates():
    from jefferson_tpu_torch import bench

    np.testing.assert_array_equal(bench.mover_positions(3000), _mover(3000))


@pytest.mark.parametrize("kind,blocks,cb,tb", [
    ("mover", 512, 512, 256), ("mover", 1024, 1024, 256), ("mover", 96, 32, 32),
    ("orbit", 200, 64, 64), ("scattered", 128, 128, 128),
])
@pytest.mark.parametrize("max_u", [256, 64])
def test_plan_onehot_chunking_is_equal(kind, blocks, cb, tb, max_u, monkeypatch):
    import jefferson_tpu.pallas.fused_step as jfs

    from jefferson_tpu_torch.kernels import fused_step as tfs

    monkeypatch.setattr(jfs, "MAX_ONEHOT_U", max_u)
    monkeypatch.setattr(tfs, "MAX_ONEHOT_U", max_u)
    pos = _mover(blocks) if kind == "mover" else _positions(kind, blocks)
    p = tplan.make_plan(pos)
    assert (trenderer.plan_onehot_chunking(p, blocks, cb, tb)
            == jrenderer.plan_onehot_chunking(p, blocks, cb, tb))


@pytest.mark.parametrize("max_ncf,rows", [(0, 256), (1, 64), (2, 64), (9, 256), (9, 64), (40, 2048)])
def test_sparse_bucket_is_equal(max_ncf, rows):
    assert trenderer._sparse_bucket(max_ncf, rows) == jrenderer._sparse_bucket(max_ncf, rows)


@pytest.mark.parametrize("flags", [
    [True], [False], [True, False], [True, False, False], [False, True, False, True], [],
])
def test_xfade_amortization_is_equal(flags):
    assert (trenderer._apply_xfade_amortization(list(flags))
            == jrenderer._apply_xfade_amortization(list(flags)))


@pytest.mark.parametrize("rows", [[], [3], [0, 5, 9], list(range(10))])
def test_pad_cf_indices_is_equal(rows):
    xf = np.zeros(16, bool)
    xf[rows] = True
    got, want = trenderer._pad_cf_indices(xf, 8), jrenderer._pad_cf_indices(xf, 8)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
