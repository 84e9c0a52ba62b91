"""Pipelined output fetch (``pipeline_fetch=True``) in the port's renderers.

A pipelined render launches chunk i+1 before it reads chunk i's output, one
chunk deep (``engine/renderer.ChunkFetch``).  The chunks run the same steps
on the same operands in the same order, so the output is bit-identical to
the synchronous fetch's: held here with ``np.array_equal`` on every arm of
both renderers, with a padded final chunk, ``mix=True``, the same
``dispatch`` both ways and ``timings``.  An error raised at a deferred read
propagates, one chunk late, and the render returns nothing.  The CPU runs
the fetch loop without a stream; tests/test_torch_cuda.py holds the side
stream's copies on the card.
"""

import numpy as np
import pytest
import torch

from jefferson_tpu_torch import bench
from jefferson_tpu_torch.config import EngineConfig
from jefferson_tpu_torch.engine import batch as tbatch
from jefferson_tpu_torch.engine import renderer as trenderer
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.trajectory.trajectory import AzimuthSweep, CircularOrbit

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tdb():
    return synthetic_database()


def _hold(b):
    return np.tile([40.0, 10.0, 1.0], (b, 1))


def _steps(b, hold):
    return AzimuthSweep(start_azi=0.0, ele=0.0, r=0.5, blocks_per_step=hold,
                        num_steps=-(-b // hold)).sample(b)


def _orbit(b):
    return CircularOrbit(period_s=0.4, ele=5, r=1.0).sample(b)


def _noise(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.2).astype(np.float32)


def _cap_tiles(monkeypatch, mod, cap=8):
    """Fused tiles of at most ``cap`` rows: a 16-block chunk's tiles do not
    own whole sources, so the batched chunks take the apply-only step (row 7)."""
    pick = mod.pick_fused_tile
    monkeypatch.setattr(mod, "pick_fused_tile",
                        lambda b, seg, max_tb=256, pick=pick: pick(b, seg, min(max_tb, cap)))


# name -> (positions, chunk_blocks, options, MAX_ONEHOT_U or None, the arm of
# every chunk); every render ends on a padded chunk
RENDERS = {
    "dedup_fused_sparse": (_steps(200, 40), 64, {}, None, ("dedup_fused", False, 8)),
    "dedup_fused": (_steps(200, 40), 64, {"sparse_xfade": False}, None, ("dedup_fused", True, None)),
    "onehot": (_orbit(80), 32, {}, None, ("onehot", True, None)),
    "onehot_grouped": (bench.mover_positions(1100), 1024, {}, 128,
                       ("onehot_grouped", True, None)),
    "gather_fused": (_orbit(70), 32, {}, 4, ("gather_fused", True, None)),
    "dedup": (_hold(70), 32, {"fused": False}, None, ("dedup", None, None)),
    "plain": (_orbit(70), 32, {"fused": False}, None, ("plain", True, None)),
}


def _arms_are(dispatch, arm):
    name, xf, bucket = arm
    assert dispatch and {a for a, _, _ in dispatch} == {name}
    assert all((xf is None or x == xf) and b == bucket for _, x, b in dispatch), dispatch


@pytest.mark.parametrize("name", list(RENDERS))
def test_renderer_pipelined_equals_synchronous(tdb, name, monkeypatch):
    pos, cb, opts, max_u, arm = RENDERS[name]
    if max_u is not None:
        monkeypatch.setattr(tfs, "MAX_ONEHOT_U", max_u)
    assert len(pos) % cb  # the final chunk is padded and trimmed
    sig = _noise(len(pos) * 128 - 333, len(name))  # the playhead wraps
    sync = Renderer(tdb, device="cpu", chunk_blocks=cb, **opts)
    piped = Renderer(tdb, device="cpu", chunk_blocks=cb, pipeline_fetch=True, **opts)
    want = sync.render(sig, pos)
    got = piped.render(sig, pos)
    assert got.shape == want.shape == (len(pos) * 128, 2)
    assert np.array_equal(got, want)
    assert piped.dispatch == sync.dispatch
    _arms_are(sync.dispatch, arm)


def test_renderer_apply_only_pipelined_equals_synchronous():
    """A history that is not a whole number of blocks (fpb 96, 256 taps):
    the fused arms take the apply-only step (row 7's twin)."""
    cfg = EngineConfig(frames_per_buffer=96, hrtf_len=256)
    db96 = synthetic_database(cfg, n_taps=256, seed=9)
    pos, sig = _orbit(50), _noise(50 * 96, 3)
    want = Renderer(db96, device="cpu", chunk_blocks=16).render(sig, pos)
    r = Renderer(db96, device="cpu", chunk_blocks=16, pipeline_fetch=True)
    assert np.array_equal(r.render(sig, pos), want)
    _arms_are(r.dispatch, ("gather_fused", True, None))


def _hold_steps(s, blocks, hold, r=1.0):
    step = np.arange(blocks) // hold
    return np.stack([np.stack([(30.0 * i + 5.0 * step) % 360.0, np.full(blocks, 5.0),
                               np.full(blocks, r)], 1) for i in range(s)])


def _wide(s, blocks, seed=11):
    rng = np.random.default_rng(seed)
    return np.stack([CircularOrbit(period_s=1.0 + 0.1 * i, ele=rng.uniform(-40, 85), r=1.0,
                                   start_azi=rng.uniform(0, 360)).sample(blocks)
                     for i in range(s)])


# name -> (signals, positions, chunk_blocks, options, gate shrinks, the arm of
# every chunk); every render ends on a padded chunk
SCENES = {
    "dedup_fused_sparse": (_noise((4, 52 * 128), 10), _hold_steps(4, 52, 20), 24, {}, {},
                           ("dedup_fused", False, 8)),
    "dedup_fused": (_noise((4, 52 * 128), 6), _hold_steps(4, 52, 1000, 0.9), 16,
                    {"sparse_xfade": False}, {}, ("dedup_fused", None, None)),
    "onehot_shared": (*bench.moving_scene(3, 37), 16, {}, {}, ("onehot_shared", True, None)),
    "onehot_grouped": (_noise((8, 20 * 128), 4), _wide(8, 20), 16, {"dedup": False},
                       {"MAX_ONEHOT_U": 32, "GROUPED_MIN_TB": 8}, ("onehot_grouped", True, None)),
    "gather_fused": (_noise((8, 20 * 128), 1), bench.wide_positions(8, 20), 16, {}, {},
                     ("gather_fused", True, None)),
    "apply_only": (_noise((8, 20 * 128), 1), bench.wide_positions(8, 20), 16, {},
                   {"tiles": 8}, ("gather_fused", True, None)),
    "apply_only_hold": (_noise((4, 52 * 128), 10), _hold_steps(4, 52, 20), 16, {},
                        {"tiles": 8}, ("dedup_fused", False, 8)),
    "dedup": (_noise((4, 52 * 128), 6), _hold_steps(4, 52, 1000, 0.9), 16, {"fused": False},
              {}, ("dedup", None, None)),
    "plain": (*bench.moving_scene(3, 37), 16, {"fused": False}, {}, ("plain", True, None)),
}


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("name", list(SCENES))
def test_batch_renderer_pipelined_equals_synchronous(tdb, name, mix, monkeypatch):
    signals, positions, cb, opts, shrinks, arm = SCENES[name]
    for gate, value in shrinks.items():
        if gate == "tiles":
            _cap_tiles(monkeypatch, tbatch, value)
        else:
            monkeypatch.setattr(tfs if gate == "MAX_ONEHOT_U" else tbatch, gate, value)
    s, b = positions.shape[:2]
    assert b % cb
    sync = BatchRenderer(tdb, device="cpu", chunk_blocks=cb, mix=mix, **opts)
    piped = BatchRenderer(tdb, device="cpu", chunk_blocks=cb, mix=mix, pipeline_fetch=True,
                          **opts)
    want = sync.render(signals, positions)
    got = piped.render(signals, positions)
    assert got.shape == want.shape == ((b * 128, 2) if mix else (s, b * 128, 2))
    assert np.array_equal(got, want)
    assert piped.dispatch == sync.dispatch
    _arms_are(sync.dispatch, arm)
    for r in (sync, piped):
        assert set(r.timings) == {"planning_s", "chunks_s"}
        assert all(v >= 0 for v in r.timings.values())


class _Unreadable:
    """A chunk output whose host read fails, as an asynchronous launch error
    surfaces at the read that waits for it."""

    def numpy(self):
        raise RuntimeError("the launch of this chunk failed")

    cpu = lambda self: self


def _fail_at_chunk(monkeypatch, k: int):
    """Both renderers' fetches hand over an unreadable output for chunk k."""

    class Failing(trenderer.ChunkFetch):
        def put(self, y, commit):
            self.n = getattr(self, "n", 0) + 1
            super().put(_Unreadable() if self.n == k else y, commit)

    for mod in (trenderer, tbatch):
        monkeypatch.setattr(mod, "ChunkFetch", Failing)


@pytest.mark.parametrize("pipelined", [False, True])
def test_an_error_at_a_deferred_read_propagates(tdb, monkeypatch, pipelined):
    """Chunk 2's read fails: synchronously before chunk 3 is launched,
    pipelined after it (one chunk deep); either way the render raises."""
    _fail_at_chunk(monkeypatch, 2)
    pos, sig = _orbit(80), _noise(80 * 128, 0)
    r = Renderer(tdb, device="cpu", chunk_blocks=16, pipeline_fetch=pipelined)
    with pytest.raises(RuntimeError, match="launch of this chunk failed"):
        r.render(sig, pos)
    assert len(r.dispatch) == (3 if pipelined else 2)
    signals, positions = bench.moving_scene(2, 40)
    b = BatchRenderer(tdb, device="cpu", chunk_blocks=8, pipeline_fetch=pipelined)
    with pytest.raises(RuntimeError, match="launch of this chunk failed"):
        b.render(signals, positions)
    assert len(b.dispatch) == (3 if pipelined else 2)


def test_an_error_at_the_last_deferred_read_propagates(tdb, monkeypatch):
    """The final chunk's read is deferred to the end of the loop."""
    _fail_at_chunk(monkeypatch, 3)
    r = Renderer(tdb, device="cpu", chunk_blocks=16, pipeline_fetch=True)
    with pytest.raises(RuntimeError, match="launch of this chunk failed"):
        r.render(_noise(40 * 128, 1), _orbit(40))
    assert len(r.dispatch) == 3


def test_chunk_fetch_commits_in_order_one_chunk_deep():
    """The fetch loop alone: a pipelined put commits the chunk before it."""
    log = []
    fetch = trenderer.ChunkFetch(torch.device("cpu"), pipelined=True)
    for i in range(3):
        fetch.put(torch.full((2,), float(i)), lambda host, i=i: log.append((i, host.tolist())))
        assert [c for c, _ in log] == list(range(i))
    fetch.finish()
    fetch.finish()  # nothing left to commit
    assert log == [(0, [0.0, 0.0]), (1, [1.0, 1.0]), (2, [2.0, 2.0])]
    sync = trenderer.ChunkFetch(torch.device("cpu"), pipelined=False)
    sync.put(torch.ones(2), lambda host: log.append(("sync", host.tolist())))
    assert log[-1] == ("sync", [1.0, 1.0])


def test_renderers_keep_the_option(tdb):
    assert Renderer(tdb, device="cpu").pipeline_fetch is False
    assert BatchRenderer(tdb, device="cpu", pipeline_fetch=True).pipeline_fetch is True
