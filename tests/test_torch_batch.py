"""The port's batched render path against the JAX package's, on CPU.

Each scene renders through the port's ``BatchRenderer(device="cpu")`` (the
CUDA steps' plain twins) and through the JAX ``BatchRenderer(fused=True)``
(its Pallas kernels interpreted).  The port must take the JAX dispatch's
arm on every chunk (read off the JAX renderer's ``_get_fn`` calls, one per
chunk), match the JAX render to 5e-7 and ``render_oracle`` to 1e-6 on
every source (tests/test_engine_parity.py:23).  The scenes are the JAX
tests' own fixtures and gate shrinks (tests/test_batch_parallel.py,
tests/test_noxfade.py), at most 8 sources and 24-block chunks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jefferson_tpu.engine.renderer as jrenderer
import jefferson_tpu.pallas.fused_step as jfs
from jefferson_tpu import EngineConfig, synthetic_database
from jefferson_tpu.bench.sweep import _batch_dispatches
from jefferson_tpu.engine import batch as jbatch
from jefferson_tpu.engine import plan as jplan
from jefferson_tpu.engine.batch import BatchRenderer as JaxBatchRenderer
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.trajectory.trajectory import CircularOrbit, StaticPosition
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.convert import database_from_numpy, hists_from_numpy, spectra_from_numpy
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
def tdb(db):
    """The port's database, carried across from the JAX fixture."""
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


def jax_arm(nb, dedup_key=None, fused_tb=None, onehot=False, group_tiles=None, nd=None, xf=True,
            ncf=None):
    """A JAX BatchRenderer program key -> the port's dispatch entry: the arm
    by ``sweep._batch_dispatches``' rule (its "xla" split into the dedup and
    plain chains), the key's ``xf`` and ``ncf``."""
    if fused_tb is not None and dedup_key is not None:
        arm = "dedup_fused"
    elif onehot:
        arm = "onehot_grouped" if group_tiles is not None else "onehot_shared"
    elif fused_tb is not None:
        arm = "gather_fused"
    else:
        arm = "dedup" if dedup_key is not None else "plain"
    return arm, xf, ncf


def record_jax_arms(r: JaxBatchRenderer) -> list:
    """Log each chunk's arm: every chunk looks its program up once."""
    arms, get_fn = [], r._get_fn

    def logged(nb, **key):
        arms.append(jax_arm(nb, **key))
        return get_fn(nb, **key)

    r._get_fn = logged
    return arms


def _jax_render(db, signals, positions, **kw):
    r = JaxBatchRenderer(db, **kw)
    arms = record_jax_arms(r)
    out = r.render(signals, positions)
    fused_names = {a for a, _, _ in arms if a not in ("dedup", "plain")}
    assert fused_names <= _batch_dispatches(r)
    return out, arms


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


def test_fused_render_matches_jax_and_oracle(db, tdb, scene, jax_fused):
    before = dict(tfs.launches)
    got = BatchRenderer(tdb, device="cpu", chunk_blocks=CB).render(*scene)
    assert tfs.launches == before
    assert got.shape == jax_fused.shape == (S, BLOCKS * db.config.frames_per_buffer, 2)
    assert np.abs(got - jax_fused).max() <= TOL_JAX
    _oracle_ok(got, *scene, db)


def test_fused_mixdown_matches_jax(tdb, scene, jax_fused):
    got = BatchRenderer(tdb, device="cpu", chunk_blocks=CB, mix=True).render(*scene)
    assert got.shape == jax_fused.shape[1:]
    assert np.abs(got - jax_fused.sum(axis=0)).max() <= TOL_JAX


@pytest.mark.parametrize("mix", [False, True])
def test_unfused_render_matches_jax(db, tdb, scene, mix):
    got = BatchRenderer(tdb, device="cpu", chunk_blocks=CB, fused=False, mix=mix).render(*scene)
    want = JaxBatchRenderer(db, chunk_blocks=CB, fused=False, mix=mix).render(*scene)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_JAX
    if not mix:
        _oracle_ok(got, *scene, db)


def test_auto_chunk_render_matches_oracle(db, tdb, config):
    """chunk_blocks=None picks the JAX package's chunk (256 for movers)."""
    signals, positions = bench.moving_scene(16, 260, config)
    plans = [jplan.make_plan(positions[i], config) for i in range(16)]
    assert tbatch._auto_chunk(16, 260, plans) == jbatch._auto_chunk(16, 260, plans) == 256
    got = BatchRenderer(tdb, device="cpu").render(signals[:, :5000], positions)
    _oracle_ok(got[::5], signals[::5, :5000], positions[::5], db)


def _parity(db, tdb, signals, positions, want_arms, **opts):
    """Render through both packages: the same arm on every chunk, the JAX
    render to 5e-7, every source to the oracle at 1e-6."""
    want, jax_arms = _jax_render(db, signals, positions, **{"fused": True, **opts})
    r = BatchRenderer(tdb, device="cpu", **opts)
    before = dict(tfs.launches)
    got = r.render(signals, positions)
    assert tfs.launches == before  # CPU tensors run the twins
    assert r.dispatch == jax_arms
    assert set(r.dispatch) == set(want_arms), r.dispatch
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_JAX
    if not opts.get("mix"):
        _oracle_ok(got, signals, positions, db)
    return r


def test_hold_scene_raises_where_jax_dedups(db, tdb, config, castanets):
    """Sources that hold their positions (tests/test_batch_parallel.py:357,
    the JAX dedup+fused gate :368): the dedup+fused arm, sparse side-pass
    (bucket 8) over the no-crossfade step, as in the JAX package; and the
    unfused chain renders it through the dedup chain, as there."""
    s, blocks = 4, 32
    signals = np.stack([np.roll(castanets, 500 * i)[:4000] for i in range(s)])
    positions = np.stack([StaticPosition(azi=25 * i, ele=10 * (i % 3) - 10, r=0.6 + 0.1 * i)
                          .sample(blocks, config) for i in range(s)])
    _parity(db, tdb, signals, positions, {("dedup_fused", False, 8)}, chunk_blocks=CB)
    _parity(db, tdb, signals, positions, {("dedup", True, None)}, chunk_blocks=CB, fused=False)


def test_wide_scene_raises(db, tdb, scene, monkeypatch):
    """Scenes wider than a shrunken compact-table gate: the gather step
    where no source group fits (3 sources do not halve), grouped tables
    where groups fit and their tiles keep GROUPED_MIN_TB rows (shrunk too),
    as in the JAX package."""
    for mod in (jfs, tfs):
        monkeypatch.setattr(mod, "MAX_ONEHOT_U", 16)
    _parity(db, tdb, *scene, {("gather_fused", True, None)}, chunk_blocks=CB)
    for mod in (jfs, tfs):
        monkeypatch.setattr(mod, "MAX_ONEHOT_U", 32)
    for mod in (jbatch, tbatch):
        monkeypatch.setattr(mod, "GROUPED_MIN_TB", 8)
    movers = (_noise(4, 32, 3), bench.scene_mover_positions(4, 32))
    _parity(db, tdb, *movers, {("onehot_grouped", True, None)}, chunk_blocks=CB)


def _cap_tiles(monkeypatch, cap=8):
    """Fused tiles of at most ``cap`` rows in both packages, so a 16-block
    chunk's tile does not own whole sources: the apply-only step (row 7),
    the JAX package's form for chunks over 256 blocks, at a CPU test's size."""
    for mod, name in ((jrenderer, "pick_fused_tile"), (tbatch, "pick_fused_tile")):
        pick = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda b, seg, max_tb=256, pick=pick:
                            pick(b, seg, min(max_tb, cap)))


def test_chunk_geometries_outside_the_one_hot_form(db, tdb, config, monkeypatch):
    """Chunks whose tiles do not own whole sources take the apply-only step
    (row 7) in the JAX package's arm; a chunk with no fused tile and an
    unaligned history take the unfused chain, as in the JAX package."""
    signals, positions = bench.moving_scene(1, 40, config)
    _parity(db, tdb, signals, positions, {("plain", True, None)}, chunk_blocks=3)
    with pytest.raises(ValueError, match="positive"):
        BatchRenderer(tdb, device="cpu", chunk_blocks=0)
    cfg96 = EngineConfig(frames_per_buffer=96, hrtf_len=256)
    db96 = synthetic_database(cfg96, n_taps=256, seed=9)
    tdb96 = database_from_numpy(db96.spectra, db96.hrirs, dataclasses.asdict(cfg96))
    sig96 = signals[:, :2000]
    pos96 = positions[:, :12]
    want = JaxBatchRenderer(db96, chunk_blocks=6, fused=True).render(sig96, pos96)
    r = BatchRenderer(tdb96, device="cpu", chunk_blocks=6)
    assert np.abs(r.render(sig96, pos96) - want).max() <= TOL_JAX
    assert set(r.dispatch) == {("plain", True, None)}
    _cap_tiles(monkeypatch)
    _parity(db, tdb, signals, positions, {("gather_fused", True, None)}, chunk_blocks=CB)


def _hold_steps(s, blocks, hold, r=1.0):
    """Sources that step 5 degrees every ``hold`` blocks (the reference's
    cadence, shortened: tests/test_noxfade.py:301)."""
    step = np.arange(blocks) // hold
    return np.stack([np.stack([(30.0 * i + 5.0 * step) % 360.0, np.full(blocks, 5.0),
                               np.full(blocks, r)], 1) for i in range(s)])


def _wide(config, castanets, s=8, blocks=16, seed=11):
    """tests/test_batch_parallel.py:432: orbits spread over the sphere."""
    rng = np.random.default_rng(seed)
    signals = np.stack([np.roll(castanets, 300 * i)[:4000] for i in range(s)])
    pos = [CircularOrbit(period_s=1.0 + 0.1 * i, ele=rng.uniform(-40, 85), r=1.0,
                         start_azi=rng.uniform(0, 360)).sample(blocks, config) for i in range(s)]
    return signals, np.stack(pos)


def _noise(s, blocks, seed):
    return (np.random.default_rng(seed).standard_normal((s, blocks * 128)) * 0.2).astype(np.float32)


# name -> (scene builder, chunk_blocks, options, gate shrinks, the arms)
ARMS = {
    # tests/test_noxfade.py:200: a crossfade at block 0 only
    "hold_sparse": (lambda c, k: (_noise(4, 48, 6), _hold_steps(4, 48, 1000, 0.9)), 16, {}, {},
                    {("dedup_fused", False, 8)}),
    "hold_sparse_off": (lambda c, k: (_noise(4, 48, 6), _hold_steps(4, 48, 1000, 0.9)), 16,
                        {"sparse_xfade": False}, {},
                        {("dedup_fused", True, None), ("dedup_fused", False, None)}),
    # tests/test_noxfade.py:301: every chunk crossfades on a few rows
    "cadence_sparse": (lambda c, k: (_noise(4, 48, 10), _hold_steps(4, 48, 20)), 24, {}, {},
                       {("dedup_fused", False, 8)}),
    # tests/test_batch_parallel.py:448
    "wide_grouped": (lambda c, k: _wide(c, k), 16, {"dedup": False},
                     {"MAX_ONEHOT_U": 32, "GROUPED_MIN_TB": 8}, {("onehot_grouped", True, None)}),
    # tests/test_batch_parallel.py:500: groups of one source, a 24-block chunk
    "grouped_single_source": (lambda c, k: _wide(c, k, s=4, blocks=24), 24, {"dedup": False},
                              {"MAX_ONEHOT_U": 16, "GROUPED_MIN_TB": 8},
                              {("onehot_grouped", True, None)}),
    # tests/test_batch_parallel.py:577: groups viable, but their tiles shrink
    "grouped_policy_gather": (lambda c, k: (_noise(8, 32, 0), np.stack([np.stack([
        (i * 45 + 25.0 * np.arange(32)) % 360.0, np.full(32, -35.0 + i * 15.0), np.full(32, 1.0)],
        1) for i in range(8)])), 16, {"dedup": False}, {}, {("gather_fused", True, None)}),
    # tests/test_batch_parallel.py:629: a new random position every block
    "wide_gather": (lambda c, k: (_noise(8, 16, 1), bench.wide_positions(8, 16)), 16, {}, {},
                    {("gather_fused", True, None)}),
    # the apply-only step (row 7) under each arm that reaches it
    "apply_only_sparse": (lambda c, k: (_noise(4, 48, 10), _hold_steps(4, 48, 20)), 16, {},
                          {"tiles": 8}, {("dedup_fused", False, 8)}),
    "apply_only_hold": (lambda c, k: (_noise(4, 48, 6), _hold_steps(4, 48, 1000, 0.9)), 16,
                        {"sparse_xfade": False}, {"tiles": 8},
                        {("dedup_fused", True, None), ("dedup_fused", False, None)}),
    "apply_only_gather": (lambda c, k: (_noise(8, 16, 1), bench.wide_positions(8, 16)), 16, {},
                          {"tiles": 8}, {("gather_fused", True, None)}),
    "unfused_hold": (lambda c, k: (_noise(4, 48, 6), _hold_steps(4, 48, 1000, 0.9)), 16,
                     {"fused": False}, {}, {("dedup", True, None), ("dedup", False, None)}),
}


@pytest.mark.parametrize("name", list(ARMS))
def test_scene_arm_matches_jax_and_oracle(db, tdb, config, castanets, name, monkeypatch):
    build, cb, opts, shrinks, arms = ARMS[name]
    for gate, value in shrinks.items():
        if gate == "tiles":
            _cap_tiles(monkeypatch, value)
        else:
            mods = (jfs, tfs) if gate == "MAX_ONEHOT_U" else (jbatch, tbatch)
            for mod in mods:
                monkeypatch.setattr(mod, gate, value)
    signals, positions = build(config, castanets)
    _parity(db, tdb, signals, positions, arms, chunk_blocks=cb, **opts)


def test_batch_renderer_refuses_what_is_not_ported(tdb):
    with pytest.raises(TypeError, match="mesh must be a torch.distributed DeviceMesh"):
        BatchRenderer(tdb, device="cpu", mesh=object())
    # the card takes fpb 64 and fpb 16 (with no card here only the device is
    # refused); fpb 2^24 needs more t-tiles than a grid's y holds, and is
    # refused before any launch, naming that resource
    for fpb in (64, 16):
        cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=512)
        tdb_f = database_from_numpy(tdb.spectra, tdb.hrirs, dataclasses.asdict(cfg))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="is_available"):
                BatchRenderer(tdb_f, device="cuda")
    big = EngineConfig(frames_per_buffer=1 << 24, hrtf_len=512)
    tdb_big = dataclasses.replace(tdb, config=big)
    with pytest.raises(ValueError, match="t-tiles of 128 columns exceed the 65535 CTAs"):
        BatchRenderer(tdb_big, device="cuda")


def test_unfused_chain_unaligned_geometry_matches_jax():
    """history_len % fpb != 0: one chunk per source, explicit windows."""
    cfg = EngineConfig(frames_per_buffer=96, hrtf_len=256)
    db96 = synthetic_database(cfg, n_taps=256, seed=9)
    tdb96 = database_from_numpy(db96.spectra, db96.hrirs, dataclasses.asdict(cfg))
    s, blocks = 2, 12
    signals = np.random.default_rng(2).standard_normal((s, 2000)).astype(np.float32) * 0.3
    positions = np.stack([CircularOrbit(period_s=0.4 + 0.1 * i, ele=5, r=1.0).sample(blocks, cfg)
                          for i in range(s)])
    got = BatchRenderer(tdb96, device="cpu", chunk_blocks=6, fused=False).render(signals, positions)
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


def test_bench_workload_parity_on_cpu(tdb):
    """The bench step at a small width: compact and per-row distance, the
    step against the oracle, and history carried from step to step."""
    for radius_step in (0.0, 0.05):
        wl = bench.build_workload(tdb, 4, 16, torch.device("cpu"), radius_step=radius_step)
        assert (wl.n_dist is None) == (radius_step > 0) or wl.n_dist == 8
        assert bench.parity_rms(wl, tdb) < 1e-6
        out, h = bench.run_step(wl)
        out2, h2 = bench.run_step(wl, h)
        assert out.shape == out2.shape == (4, 16, 128, 2)
        assert torch.equal(h2, torch.cat([h, wl.feds], dim=1)[:, 16 * 128 :])
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu"])
