"""The port's single-source Renderer against the JAX package's, on CPU.

Each case renders through ``Renderer(device="cpu")`` (the CUDA steps' plain
twins) and through the JAX ``Renderer(fused=...)`` (its Pallas kernels
interpreted), and must match it to 5e-7, ``render_oracle`` to 1e-6
(tests/test_engine_parity.py:23), and take the JAX renderer's arm on every
chunk.  The JAX arms are read off its program caches: every chunk looks
its program up once, so a recording cache logs the arm chunk by chunk.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jefferson_tpu import EngineConfig, ProcessType, synthetic_database
from jefferson_tpu.engine.renderer import Renderer as JaxRenderer
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.pallas import fused_step as jfs
from jefferson_tpu.trajectory.trajectory import AzimuthSweep, CircularOrbit
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.engine.plan import make_plan
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.kernels import fused_step as tfs

torch.set_num_threads(1)

TOL_JAX = 5e-7
TOL_ORACLE = 1e-6

@pytest.fixture(scope="module")
def tdb(db):
    """The port's database, carried across from the JAX fixture."""
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


# JAX program cache -> (arm, with_xfade, sparse bucket) from its key
_CACHES = {
    "_fd_dedup_fused": lambda k: ("dedup_fused", k[3], k[4]),
    "_fd_onehot": lambda k: ("onehot", True, None),
    "_fd_onehot_grp": lambda k: ("onehot_grouped", True, None),
    "_fd_fused": lambda k: ("gather_fused", k[2], None),
    "_fd_dedup": lambda k: ("dedup", k[1], None),
    "_fd_complex": lambda k: ("plain", k[1], None),
}


class _Recorder(dict):
    def __init__(self, arm, log):
        super().__init__()
        self.arm, self.log = arm, log

    def __getitem__(self, key):
        self.log.append(self.arm(key))
        return super().__getitem__(key)


def _jax_render(db, sig, pos, initial_old, **kw):
    r = JaxRenderer(db, **kw)
    arms = []
    for name, arm in _CACHES.items():
        setattr(r, name, _Recorder(arm, arms))
    return r.render(sig, pos, initial_old=initial_old), arms


def _hold(b):
    return np.tile([40.0, 10.0, 1.0], (b, 1))


def _steps(b, hold):
    """A 5-degree azimuth step every ``hold`` blocks (the reference's sweep
    cadence, shortened)."""
    return AzimuthSweep(start_azi=0.0, ele=0.0, r=0.5, blocks_per_step=hold,
                        num_steps=b // hold).sample(b)


def _orbit(b, radius_step=0.0):
    pos = CircularOrbit(period_s=0.4, ele=5, r=1.0).sample(b)
    pos[:, 2] += radius_step * np.arange(b)
    return pos


# name: (positions, chunk_blocks, renderer options, initial_old, MAX_ONEHOT_U, arms)
CASES = {
    # test_noxfade.py:152-197: a crossfade at block 0 only
    "hold": (_hold(96), 32, {}, (0.0, 0.0), None,
             [("dedup_fused", True, None)] + [("dedup_fused", False, None)] * 2),
    "hold_no_crossfade": (_hold(64), 32, {}, None, None, [("dedup_fused", False, None)] * 2),
    "hold_partial_chunk": (_hold(100), 32, {}, (0.0, 0.0), None,
                           [("dedup_fused", True, None)] + [("dedup_fused", False, None)] * 3),
    "sparse": (_steps(192, 40), 64, {}, (0.0, 0.0), None, [("dedup_fused", False, 8)] * 3),
    "sparse_off": (_steps(192, 40), 64, {"sparse_xfade": False}, (0.0, 0.0), None,
                   [("dedup_fused", True, None)] * 3),
    "onehot_partial_chunk": (_orbit(80), 32, {}, (0.0, 0.0), None, [("onehot", True, None)] * 3),
    "onehot_per_row_distance": (_orbit(64, 0.01), 32, {}, (0.0, 0.0), None,
                                [("onehot", True, None)] * 2),
    "grouped": (bench.mover_positions(1024), 1024, {}, (0.0, 0.0), 128,
                [("onehot_grouped", True, None)]),
    "gather_no_crossfade": (_hold(64), 32, {"dedup": False}, None, None,
                            [("gather_fused", False, None)] * 2),
    "gather_mixed": (_hold(96), 32, {"dedup": False}, (0.0, 0.0), 4,
                     [("gather_fused", True, None)] + [("gather_fused", False, None)] * 2),
    "gather_mover": (_orbit(64), 32, {}, (0.0, 0.0), 4, [("gather_fused", True, None)] * 2),
    "unfused_hold": (_hold(96), 32, {"fused": False}, (0.0, 0.0), None,
                     [("dedup", True, None)] + [("dedup", False, None)] * 2),
    "unfused_mover": (_orbit(80), 32, {"fused": False}, (0.0, 0.0), None,
                      [("plain", True, None)] * 3),
    "no_tile": (_orbit(37), 2048, {}, (0.0, 0.0), None, [("plain", True, None)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_renderer_matches_jax_and_oracle(db, tdb, config, name, monkeypatch):
    pos, cb, opts, initial_old, max_u, arms = CASES[name]
    if max_u is not None:
        monkeypatch.setattr(jfs, "MAX_ONEHOT_U", max_u)
        monkeypatch.setattr(tfs, "MAX_ONEHOT_U", max_u)
    rng = np.random.default_rng(len(name))
    sig = (rng.standard_normal(len(pos) * config.frames_per_buffer) * 0.2).astype(np.float32)
    jax_opts = {"fused": True, **opts}
    want, jax_arms = _jax_render(db, sig, pos, initial_old, chunk_blocks=cb, **jax_opts)
    r = Renderer(tdb, device="cpu", chunk_blocks=cb, **opts)
    before = dict(tfs.launches)
    got = r.render(sig, pos, initial_old=initial_old)
    assert tfs.launches == before  # CPU tensors run the twins
    assert r.dispatch == jax_arms == arms
    assert got.shape == want.shape == (len(pos) * config.frames_per_buffer, 2)
    assert np.abs(got - want).max() <= TOL_JAX
    oracle = render_oracle(sig, db, [tuple(p) for p in pos], config, initial_old=initial_old)
    assert np.abs(got - oracle).max() <= TOL_ORACLE


def test_render_plan_and_dispatch_reset(tdb, config):
    """render_plan takes a prepared plan; each render replaces the log."""
    sig = np.random.default_rng(0).standard_normal(40 * 128).astype(np.float32) * 0.2
    r = Renderer(tdb, device="cpu", chunk_blocks=16)
    a = r.render_plan(sig, make_plan(_hold(40), config))
    assert len(r.dispatch) == 3
    b = r.render(sig, _hold(40))
    assert len(r.dispatch) == 3
    np.testing.assert_array_equal(a, b)


def test_renderer_raises_where_the_port_stops(tdb, config):
    sig = np.zeros(4096, np.float32)
    r = Renderer(tdb, device="cpu")
    # -t 1 and -t 2 are ported (tests/test_torch_process_types.py): they render
    for ptype, arm in ((ProcessType.TPU_TD, "td"), (ProcessType.TPU_FD_BASIC, "fd_basic")):
        assert r.render(sig, _hold(8), ptype=ptype).shape == (8 * 128, 2)
        assert r.dispatch == [(arm, False, None)]
    with pytest.raises(ValueError, match="unknown fft backend"):
        Renderer(tdb, device="cpu", backend="dct")
    with pytest.raises(TypeError, match="mesh must be a torch.distributed DeviceMesh"):
        Renderer(tdb, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="positive"):
        Renderer(tdb, device="cpu", chunk_blocks=0)
    plan = make_plan(_orbit(8), config)
    plan.idx_old[3, 0] += 1
    with pytest.raises(ValueError, match="previous block's new arrays"):
        r.render_plan(sig, plan)


@pytest.mark.parametrize("case", ["gather", "dedup", "unfused"])
def test_unaligned_history_needs_the_unfused_arms(case):
    """A history that is not a whole number of blocks (fpb 96, 256 taps):
    the fused arms take the apply-only step (row 7, its twin here), as the
    JAX package's fused arms take its apply-only kernel; the unfused arm
    renders as the JAX package's fused=False does.  The card takes the
    geometry, so a CUDA device takes it too (its kernels build
    for fpb 96 / pad 512): with no card here, only the device is refused."""
    cfg = EngineConfig(frames_per_buffer=96, hrtf_len=256)
    db96 = synthetic_database(cfg, n_taps=256, seed=9)
    tdb96 = database_from_numpy(db96.spectra, db96.hrirs, dataclasses.asdict(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            Renderer(tdb96, device="cuda")
    sig = np.random.default_rng(1).standard_normal(3000).astype(np.float32) * 0.3
    cb = 16 if case == "dedup" else 8  # the dedup takes chunks of 16 hold blocks
    if case == "dedup":
        pos = np.tile([40.0, 10.0, 1.0], (48, 1))
        opts, arms = {}, [("dedup_fused", True, None)] + [("dedup_fused", False, None)] * 2
    else:
        pos = CircularOrbit(period_s=0.3, ele=5, r=1.0).sample(24, cfg)
        opts = {"fused": False} if case == "unfused" else {}
        arms = [("plain" if case == "unfused" else "gather_fused", True, None)] * 3
    r = Renderer(tdb96, device="cpu", chunk_blocks=cb, **opts)
    before = dict(tfs.launches)
    got = r.render(sig, pos)
    assert tfs.launches == before
    want, jax_arms = _jax_render(db96, sig, pos, (0.0, 0.0), chunk_blocks=cb,
                                 **{"fused": True, **opts})
    assert r.dispatch == jax_arms == arms
    assert np.abs(got - want).max() <= TOL_JAX
    oracle = render_oracle(sig, db96, [tuple(p) for p in pos], cfg)
    assert np.abs(got - oracle).max() <= TOL_ORACLE


def test_full_size_dispatch_matches_jax(db, tdb, config, monkeypatch):
    """The arms ``chip_smoke.py`` holds the card's single-source path to,
    at full size (12,556 blocks in chunks of 2048): both renderers plan
    every chunk with their chunk programs stubbed out, and take the same
    arm on every chunk."""
    import importlib.util
    from pathlib import Path

    import jax.numpy as jnp

    from jefferson_tpu_torch.engine import renderer as trenderer

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    fpb = config.frames_per_buffer
    for fn in ("_fd_complex_chunk_dedup_fused", "_fd_complex_chunk_onehot",
               "_fd_complex_chunk_onehot_grouped", "_fd_complex_chunk_fused",
               "_fd_complex_chunk_dedup", "_fd_complex_chunk"):
        monkeypatch.setattr(trenderer, fn, lambda spectra, hist, *a, num_blocks, **k:
                            (torch.zeros(num_blocks, fpb, 2), hist))
    jax_stub = lambda nb, *a, **k: (lambda *args: (jnp.zeros((nb, fpb, 2), jnp.float32), args[1]))
    sig = np.zeros(smoke.SIGNAL_SAMPLES, np.float32)
    for name, (pos, opts, arm) in smoke.renders(bench).items():
        r = JaxRenderer(db, fused=True, **opts)
        for mk in ("_mk_fd_dedup_fused", "_mk_fd_onehot", "_mk_fd_onehot_grp", "_mk_fd_fused",
                   "_mk_fd_dedup", "_mk_fd_complex"):
            setattr(r, mk, jax_stub)
        jax_arms = []
        for cache, arm_of in _CACHES.items():
            setattr(r, cache, _Recorder(arm_of, jax_arms))
        r.render(sig, pos)
        port = Renderer(tdb, device="cpu", **opts)
        port.render(sig, pos)
        assert len(pos) == 12556 and len(port.dispatch) == 7, name
        assert port.dispatch == jax_arms == [arm] * 7, name
