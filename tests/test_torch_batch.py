"""The port's batched render path against the JAX package's, on CPU.

Moving scenes (``bench.moving_scene``) are what the JAX BatchRenderer sends
through the shared one-hot step; the port renders them through the same
step (its plain twin here) and must match the JAX renderer to 5e-7 and
``render_oracle`` to 1e-6 (tests/test_engine_parity.py:23).  Where the JAX
dispatch leaves that form, the port raises NotImplementedError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu import EngineConfig, synthetic_database
from jefferson_tpu.engine import batch as jbatch
from jefferson_tpu.engine import plan as jplan
from jefferson_tpu.engine.batch import BatchRenderer as JaxBatchRenderer
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.trajectory.trajectory import CircularOrbit, StaticPosition
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.convert import hists_from_numpy, spectra_from_numpy
from jefferson_tpu_torch.engine import batch as tbatch
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.kernels import fused_step as tfs

torch.set_num_threads(1)

TOL_JAX = 5e-7
TOL_ORACLE = 1e-6
S, BLOCKS, CB = 3, 37, 16  # 37 % 16 != 0: the final chunk is padded


@pytest.fixture(scope="module")
def scene(config):
    return bench.moving_scene(S, BLOCKS, config)


@pytest.fixture(scope="module")
def jax_fused(db, scene):
    """The JAX renderer's own fused render (interpret-mode Pallas on CPU),
    and the proof that it took the shared one-hot form."""
    r = JaxBatchRenderer(db, chunk_blocks=CB, fused=True)
    out = r.render(*scene)
    # jit keys: (nb, dedup_key, fused_tb, onehot, group_tiles, nd, xf, ncf)
    keys = list(r._jitted)
    assert keys and all(k[1] is None and k[2] is not None and k[3] and k[4] is None for k in keys)
    return out


def _oracle_ok(out, signals, positions, db):
    for i in range(signals.shape[0]):
        want = render_oracle(signals[i], db, [tuple(p) for p in positions[i]], db.config)
        assert np.abs(out[i] - want).max() <= TOL_ORACLE, f"source {i}"


def test_fused_render_matches_jax_and_oracle(db, scene, jax_fused):
    before = dict(tfs.launches)
    got = BatchRenderer(db, device="cpu", chunk_blocks=CB).render(*scene)
    assert tfs.launches == before
    assert got.shape == jax_fused.shape == (S, BLOCKS * db.config.frames_per_buffer, 2)
    assert np.abs(got - jax_fused).max() <= TOL_JAX
    _oracle_ok(got, *scene, db)


def test_fused_mixdown_matches_jax(db, scene, jax_fused):
    got = BatchRenderer(db, device="cpu", chunk_blocks=CB, mix=True).render(*scene)
    assert got.shape == jax_fused.shape[1:]
    assert np.abs(got - jax_fused.sum(axis=0)).max() <= TOL_JAX


@pytest.mark.parametrize("mix", [False, True])
def test_unfused_render_matches_jax(db, scene, mix):
    got = BatchRenderer(db, device="cpu", chunk_blocks=CB, fused=False, mix=mix).render(*scene)
    want = JaxBatchRenderer(db, chunk_blocks=CB, fused=False, mix=mix).render(*scene)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_JAX
    if not mix:
        _oracle_ok(got, *scene, db)


def test_auto_chunk_render_matches_oracle(db, config):
    """chunk_blocks=None picks the JAX package's chunk (256 for movers)."""
    signals, positions = bench.moving_scene(16, 260, config)
    plans = [jplan.make_plan(positions[i], config) for i in range(16)]
    assert tbatch._auto_chunk(16, 260, plans) == jbatch._auto_chunk(16, 260, plans) == 256
    got = BatchRenderer(db, device="cpu").render(signals[:, :5000], positions)
    _oracle_ok(got[::5], signals[::5, :5000], positions[::5], db)


def test_hold_scene_raises_where_jax_dedups(db, config):
    s, blocks = 4, 32
    signals = np.random.default_rng(0).standard_normal((s, 4000)).astype(np.float32)
    positions = np.stack([StaticPosition(azi=25 * i, ele=10, r=0.6 + 0.1 * i).sample(blocks, config)
                          for i in range(s)])
    r = JaxBatchRenderer(db, chunk_blocks=CB, fused=False)
    r.render(signals, positions)
    assert any(k[1] is not None for k in r._jitted), "the JAX renderer took its dedup path"
    with pytest.raises(NotImplementedError, match="hold scene.*queue 2 item 1"):
        BatchRenderer(db, device="cpu", chunk_blocks=CB).render(signals, positions)
    # the unfused chain renders it all the same
    got = BatchRenderer(db, device="cpu", chunk_blocks=CB, fused=False).render(signals, positions)
    assert np.abs(got - r.render(signals, positions)).max() <= TOL_JAX


def test_wide_scene_raises(db, scene, monkeypatch):
    monkeypatch.setattr(tfs, "MAX_ONEHOT_U", 16)
    with pytest.raises(NotImplementedError, match="wide scene.*MAX_ONEHOT_U=16"):
        BatchRenderer(db, device="cpu", chunk_blocks=CB).render(*scene)


def test_chunk_geometries_outside_the_one_hot_form(db, config):
    signals, positions = bench.moving_scene(1, 600, config)
    with pytest.raises(NotImplementedError, match="chunk_blocks=512"):
        BatchRenderer(db, device="cpu", chunk_blocks=512).render(signals, positions)
    with pytest.raises(ValueError, match="no fused tile"):
        BatchRenderer(db, device="cpu", chunk_blocks=3).render(signals[:, :1280], positions[:, :10])
    with pytest.raises(ValueError, match="positive"):
        BatchRenderer(db, device="cpu", chunk_blocks=0)
    cfg96 = EngineConfig(frames_per_buffer=96, hrtf_len=256)
    db96 = synthetic_database(cfg96, n_taps=256, seed=9)
    with pytest.raises(ValueError, match="fused=False"):
        BatchRenderer(db96, device="cpu")


def test_unfused_chain_unaligned_geometry_matches_jax():
    """history_len % fpb != 0: one chunk per source, explicit windows."""
    cfg = EngineConfig(frames_per_buffer=96, hrtf_len=256)
    db96 = synthetic_database(cfg, n_taps=256, seed=9)
    s, blocks = 2, 12
    signals = np.random.default_rng(2).standard_normal((s, 2000)).astype(np.float32) * 0.3
    positions = np.stack([CircularOrbit(period_s=0.4 + 0.1 * i, ele=5, r=1.0).sample(blocks, cfg)
                          for i in range(s)])
    got = BatchRenderer(db96, device="cpu", chunk_blocks=6, fused=False).render(signals, positions)
    want = JaxBatchRenderer(db96, chunk_blocks=6, fused=False, dedup=False).render(signals, positions)
    assert np.abs(got - want).max() <= TOL_JAX


@pytest.mark.parametrize("with_xfade", [True, False])
def test_resume_from_jax_history(db, config, with_xfade):
    """A chunk that starts from a history the JAX package produced gives the
    JAX package's next chunk (convert.hists_from_numpy, spectra_from_numpy)."""
    s, nb = 2, 8
    signals, positions = bench.moving_scene(s, 2 * nb, config)
    plans = [jplan.make_plan(positions[i], config) for i in range(s)]
    feds = np.stack([jplan.fed_stream(signals[i], 2 * nb, config) for i in range(s)])
    fpb = config.frames_per_buffer
    names = ("idx_new", "w_new", "idx_old", "w_old", "xfade", "u_hi", "u_lo", "inv_frac")
    chunk = lambda k: [np.stack([getattr(p, a)[k * nb : (k + 1) * nb] for p in plans]) for a in names]
    spectra = (np.real(db.spectra).astype(np.float32), np.imag(db.spectra).astype(np.float32))
    jfn = jax.jit(jbatch.batched_chunk_fn(config, nb, with_xfade=with_xfade))
    _, h1 = jfn(tuple(map(jnp.asarray, spectra)), jnp.zeros((s, config.history_len)),
                jnp.asarray(feds[:, : nb * fpb]), *map(jnp.asarray, chunk(0)))
    y2, h2 = jfn(tuple(map(jnp.asarray, spectra)), h1, jnp.asarray(feds[:, nb * fpb :]),
                 *map(jnp.asarray, chunk(1)))
    tfn = tbatch.batched_chunk_fn(config, nb, with_xfade=with_xfade)
    got, h = tfn(spectra_from_numpy(spectra, "cpu"), hists_from_numpy(h1, "cpu"),
                 torch.from_numpy(feds[:, nb * fpb :]), *map(torch.from_numpy, chunk(1)))
    assert np.abs(got.numpy() - np.asarray(y2)).max() <= TOL_JAX
    np.testing.assert_array_equal(h.numpy(), np.asarray(h2))


def test_spectra_from_numpy_forms(db):
    re, im = spectra_from_numpy(db.spectra, "cpu")
    assert re.shape == im.shape == (710, 2, 513) and re.dtype == torch.float32
    np.testing.assert_array_equal(re.numpy(), np.real(db.spectra).astype(np.float32))
    re2, im2 = spectra_from_numpy((np.real(db.spectra), jnp.asarray(np.imag(db.spectra))), "cpu")
    assert torch.equal(re, re2) and torch.equal(im, im2)
    h = hists_from_numpy(jnp.ones((2, 896), jnp.float32), "cpu")
    assert h.shape == (2, 896) and h.dtype == torch.float32 and h.is_contiguous()


def test_bench_workload_parity_on_cpu(db):
    """The bench step at a small width: compact and per-row distance, the
    step against the oracle, and history carried from step to step."""
    for radius_step in (0.0, 0.05):
        wl = bench.build_workload(db, 4, 16, torch.device("cpu"), radius_step=radius_step)
        assert (wl.n_dist is None) == (radius_step > 0) or wl.n_dist == 8
        assert bench.parity_rms(wl, db) < 1e-6
        out, h = bench.run_step(wl)
        out2, h2 = bench.run_step(wl, h)
        assert out.shape == out2.shape == (4, 16, 128, 2)
        assert torch.equal(h2, torch.cat([h, wl.feds], dim=1)[:, 16 * 128 :])
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu"])
