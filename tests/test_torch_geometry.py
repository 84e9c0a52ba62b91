"""The port at block and transform sizes other than fpb 128 / pad 1024, on
the CPU: each kernel's plain twin against the JAX package's Pallas kernel
in interpret mode, the renderers and the streaming engine against the JAX
package's at every named geometry with the JAX dispatch's arms, the
geometries the card takes and the one resource it refuses for, and the
per-geometry library keys.

The named geometries (44.1 kHz): f64 (64-sample blocks, the 512-tap set:
pad 1024, Q 16), f256 (Q 4), f64t256 (64-sample blocks of a 256-tap set:
pad 512), f1024 (1024-sample blocks: pad 2048, 1025 bins), and the two
histories of partial blocks f100 and f441 (10 ms), which take the
apply-only kernels (rows 7 and 8) on XD computed outside them; and the
geometries the card once refused: f16, f4 and f2 (low-latency blocks: Q
64, 256 and 512 at pad 1024), f2048 (2,048-sample blocks: pad 4096, 16
t-tiles) and f128t2048 (a 2,048-tap set at the default block: pad 4096, Q
32).

At Q 256 and 512 (f4, f2) a Pallas kernel with the sliding forward, and a
JAX render through one, takes 40-300 s to build (the kernel's twiddle loop
is unrolled Q times), so there the forward twin is held to the JAX
package's sliding forward (``ops.fft.rfft_sliding_split_batched``, eager),
rows 7 and 8 to their Pallas kernels, and the renders and scenes to the
JAX package's oracle (``render_oracle``) with the arms of the JAX
dispatch run with its chunk programs stubbed out; the streaming forms to
the JAX stream as everywhere.  f16, f2048 and f128t2048 face the Pallas
kernels too, and f2048 one JAX render.

Tolerances: 5e-7 max-abs for a twin against its Pallas kernel (the JAX
package's fused-vs-unfused gate, tests/test_batch_parallel.py:834), 1e-5
for row 8 (tests/test_pallas.py:56, standard-normal planes), 1e-6 of the
planes' peak for the forward (FWD_REL, tests/test_torch_ops.py), and 1e-6
for a render against the JAX render or the oracle
(tests/test_engine_parity.py:23).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu import EngineConfig as JaxConfig
from jefferson_tpu import synthetic_database
from jefferson_tpu.engine import stream as jstream
from jefferson_tpu.engine.batch import BatchRenderer as JaxBatchRenderer
from jefferson_tpu.engine.renderer import Renderer as JaxRenderer
from jefferson_tpu.ops.fft import rfft_sliding_split_batched as j_sliding
from jefferson_tpu.ops.filters import cmul as jcmul
from jefferson_tpu.ops.filters import distance_factors_split as jdistance
from jefferson_tpu.ops.filters import distance_phase_split
from jefferson_tpu.pallas import fused_apply as jfa
from jefferson_tpu.pallas import fused_step as jfs
from jefferson_tpu.pallas.fused_spatializer import fused_apply as j_fused_apply
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.pallas.fused_spatializer import kernel_planes as j_kernel_planes
from jefferson_tpu.trajectory.trajectory import CircularOrbit
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.config import EngineConfig
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.engine import stream as tstream
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.engine.renderer import Renderer, check_card_geometry
from jefferson_tpu_torch.kernels import build
from jefferson_tpu_torch.kernels import fused_apply as tfa
from jefferson_tpu_torch.kernels import fused_spatializer as tsp
from jefferson_tpu_torch.kernels import fused_step as tfs

from test_torch_batch import jax_arm, record_jax_arms
from test_torch_renderer import _CACHES, _Recorder, _hold, _jax_render, _orbit

torch.set_num_threads(1)

TOL = 5e-7
TOL_ROW8 = 1e-5
TOL_JAX = 1e-6
FWD_REL = 1e-6

# name: (frames_per_buffer, HRIR taps)
GEOMETRIES = {
    "f64": (64, 512), "f256": (256, 512), "f64t256": (64, 256), "f1024": (1024, 512),
    "f100": (100, 512), "f441": (441, 512),
    "f16": (16, 512), "f4": (4, 512), "f2": (2, 512), "f2048": (2048, 512),
    "f128t2048": (128, 2048),
}
# the whole-block geometries whose Pallas kernels interpret in seconds
ALIGNED = ("f64", "f256", "f64t256", "f1024", "f16", "f2048", "f128t2048")
RENDERED = ("f64", "f256", "f64t256", "f100", "f441")
# the geometries past the card's old envelope, and those of them at Q 256
# and 512 (the module docstring)
NEW = ("f16", "f4", "f2", "f2048", "f128t2048")
LARGE_Q = ("f4", "f2")


@functools.cache
def _dbs(name):
    """(JAX database, the port's database) of a named geometry."""
    fpb, taps = GEOMETRIES[name]
    cfg = JaxConfig(frames_per_buffer=fpb, hrtf_len=taps)
    db = synthetic_database(cfg, n_taps=taps, seed=11)
    return db, database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(cfg))


def _j(a):
    return None if a is None else jnp.asarray(a.numpy())


def _run(fn, args, kw):
    """The wrapper on CPU operands: its twin, never a kernel."""
    before = dict(tfs.launches)
    got = fn(*args, **kw)
    assert tfs.launches == before
    return got.numpy()


def _pallas(fn, args, kw, tb):
    jkw = {**kw, "tb": tb}
    if "dsel" in jkw:
        jkw["dsel"] = _j(jkw["dsel"])
    module = jfa if fn is tfa.fused_apply_xfade else jfs
    return np.asarray(getattr(module, fn.__name__)(*map(_j, args), **jkw))


# form: (operand maker, its arguments, the Pallas tile)
STEPS = {
    "onehot": (bench.stream_step, dict(form="onehot", b=16, xf_every=3), 8),
    "grouped": (bench.stream_step, dict(form="grouped", b=16, tb=8, group_tiles=1), 8),
    "gather": (bench.scene_step, dict(form="gather", s=2, nb=8, xf_every=3), 8),
    "gather_noxf": (bench.scene_step, dict(form="gather_noxf", s=2, nb=8), 8),
    "apply": (bench.scene_step, dict(form="apply", s=2, nb=8, xf_every=3), 8),
}


@pytest.mark.parametrize("form", list(STEPS))
@pytest.mark.parametrize("name", ALIGNED)
def test_twins_match_the_pallas_kernels_at_each_geometry(name, form):
    """Rows 4 and 3 (one stream), 6 in both forms and 7 (two sources), at
    each whole-block geometry, against the Pallas kernels interpreted."""
    _, tdb = _dbs(name)
    make, opts, tb = STEPS[form]
    fn, args, kw = make(tdb, device="cpu", seed=5, **opts)
    got = _run(fn, args, kw)
    fpb = GEOMETRIES[name][0]
    assert got.shape == (16, 2 * fpb)
    assert np.abs(got - _pallas(fn, args, kw, tb)).max() <= TOL


@pytest.mark.parametrize("name", ("f64", "f256", "f64t256", "f1024", "f441") + NEW)
def test_row_8_twin_matches_the_pallas_kernel_at_each_geometry(name):
    """Row 8's apply-only entry on 16 rows of standard-normal planes, a
    crossfade on some, every bracket a random table row."""
    db, tdb = _dbs(name)
    cfg, b = tdb.config, 16
    rng = np.random.default_rng(len(name))
    xr, xi = (rng.standard_normal((b, cfg.num_bins)).astype(np.float32) for _ in range(2))
    n = db.spectra.shape[0]
    idxo, idxn = (rng.integers(0, n, (b, 4)).astype(np.int32) for _ in range(2))
    wo, wn = (rng.random((b, 4)).astype(np.float32) for _ in range(2))
    xf = rng.random(b) > 0.4
    uh, ul, fr = distance_phase_split(cfg.fsvs, rng.random(b).astype(np.float32), cfg.num_bins)
    jxdr, jxdi = jcmul(jnp.asarray(xr), jnp.asarray(xi),
                       *jdistance(jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(fr), cfg.num_bins))
    want = np.asarray(j_fused_apply(
        j_kernel_planes(db), jxdr, jxdi, jnp.asarray(np.concatenate([idxo, idxn], 1)),
        jnp.asarray(np.concatenate([wo, wn], 1)), jnp.asarray(xf), db.config, tb=8,
        interpret=True))
    t = torch.from_numpy
    got = _run(tsp.fused_apply_packed,
               (tsp.kernel_planes(tdb, "cpu"), t(np.array(jxdr)), t(np.array(jxdi)),
                t(np.concatenate([idxo, idxn], 1)), t(np.concatenate([wo, wn], 1)), t(xf)),
               dict(bins=cfg.num_bins, fpb=cfg.frames_per_buffer))
    assert got.shape == want.shape == (b, cfg.frames_per_buffer, 2)
    assert np.abs(got - want).max() <= TOL_ROW8


@pytest.mark.parametrize("name", LARGE_Q)
def test_apply_twin_matches_the_pallas_kernel_at_large_q(name):
    """Row 7 (XD computed outside it) at Q 256 and 512, against its Pallas
    kernel interpreted."""
    _, tdb = _dbs(name)
    make, opts, tb = STEPS["apply"]
    fn, args, kw = make(tdb, device="cpu", seed=5, **opts)
    got = _run(fn, args, kw)
    assert got.shape == (16, 2 * GEOMETRIES[name][0])
    assert np.abs(got - _pallas(fn, args, kw, tb)).max() <= TOL


@pytest.mark.parametrize("name", ("f16",) + LARGE_Q)
def test_forward_twin_matches_the_jax_sliding_forward_at_large_q(name):
    """Rows 1-6's launch A twin (the sliding forward times the distance
    planes, per row and by triple) against the JAX package's sliding
    forward and distance planes, two streams of 12 blocks."""
    _, tdb = _dbs(name)
    cfg = tdb.config
    fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
    q, s, nb = pad // fpb, 2, 12
    rng = np.random.default_rng(q)
    streams = (rng.standard_normal((s, (nb + q - 1) * fpb)) * 0.2).astype(np.float32)
    uh, ul, fr = distance_phase_split(cfg.fsvs, rng.random(s * nb).astype(np.float32) + 0.5, bins)
    jxr, jxi = j_sliding(jnp.asarray(streams), nb, fpb, pad)
    jdr, jdi = jdistance(jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(fr), bins)
    want = [np.asarray(p).reshape(s * nb, bins)
            for p in jcmul(jxr.reshape(s * nb, bins), jxi.reshape(s * nb, bins), jdr, jdi)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    col = lambda a: t(a)[:, None]
    got = tfs._forward_reference(t(streams), nb, col(uh), col(ul), col(fr), None, None,
                                 pad_len=pad, bins=bins, fpb=fpb)
    peak = max(np.abs(w).max() for w in want)
    assert max(np.abs(g.numpy() - w).max() for g, w in zip(got, want)) <= FWD_REL * peak
    # by triple: row r takes triple r % 3 of the first three rows' planes
    sel = torch.arange(s * nb, dtype=torch.int32)[:, None] % 3
    got = tfs._forward_reference(t(streams), nb, col(uh), col(ul), col(fr), sel, 3,
                                 pad_len=pad, bins=bins, fpb=fpb)
    idx = sel[:, 0].numpy()
    want = [np.asarray(p) for p in jcmul(jxr.reshape(s * nb, bins), jxi.reshape(s * nb, bins),
                                          jdr[idx], jdi[idx])]
    assert max(np.abs(g.numpy() - w).max() for g, w in zip(got, want)) <= FWD_REL * peak


def _signal(blocks, fpb, seed):
    return (np.random.default_rng(seed).standard_normal(blocks * fpb) * 0.2).astype(np.float32)


# case: (positions of 48 blocks, chunk_blocks, renderer options)
RENDERS = {
    "hold": (_hold(48), 16, {}),
    "orbit": (_orbit(48), 16, {}),
    "gather": (_orbit(48), 16, {"dedup": False}),
}


@pytest.mark.parametrize("case", list(RENDERS))
@pytest.mark.parametrize("name", RENDERED)
def test_renderer_matches_jax_at_each_geometry(name, case, monkeypatch):
    """The dedup+fused, one-hot and gather arms (at a history of partial
    blocks, what the JAX dispatch takes there), each chunk on the JAX arm."""
    db, tdb = _dbs(name)
    pos, cb, opts = RENDERS[case]
    if case == "gather":  # the orbit's filters overflow the one-hot gate
        monkeypatch.setattr(jfs, "MAX_ONEHOT_U", 4)
        monkeypatch.setattr(tfs, "MAX_ONEHOT_U", 4)
    sig = _signal(len(pos), GEOMETRIES[name][0], 3)
    want, jax_arms = _jax_render(db, sig, pos, (0.0, 0.0), chunk_blocks=cb, fused=True, **opts)
    r = Renderer(tdb, device="cpu", chunk_blocks=cb, **opts)
    got = r.render(sig, pos)
    assert r.dispatch == jax_arms and len(jax_arms) == 3
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_JAX


def _stub_jax_renderer(r, fpb):
    """A JAX Renderer's chunk programs stubbed out: it plans and dispatches
    every chunk, runs no kernel."""
    jax_stub = lambda nb, *a, **k: (lambda *args: (jnp.zeros((nb, fpb, 2), jnp.float32), args[1]))
    for mk in ("_mk_fd_dedup_fused", "_mk_fd_onehot", "_mk_fd_onehot_grp", "_mk_fd_fused",
               "_mk_fd_dedup", "_mk_fd_complex"):
        setattr(r, mk, jax_stub)


def _jax_arms(db, sig, pos, **kw):
    """The arms the JAX dispatch takes on every chunk of a render."""
    r = JaxRenderer(db, fused=True, **kw)
    _stub_jax_renderer(r, db.config.frames_per_buffer)
    arms = []
    for cache, arm_of in _CACHES.items():
        setattr(r, cache, _Recorder(arm_of, arms))
    r.render(sig, pos)
    return arms


def _oracle(db, sig, pos):
    return render_oracle(sig, db, [tuple(p) for p in pos], db.config, initial_old=(0.0, 0.0))


@pytest.mark.parametrize("case", list(RENDERS))
@pytest.mark.parametrize("name", NEW)
def test_renderer_matches_the_oracle_with_the_jax_arms_at_the_new_geometries(name, case,
                                                                              monkeypatch):
    """The dedup+fused, one-hot and gather arms past the old envelope: each
    chunk on the JAX dispatch's arm, the render within 1e-6 of the JAX
    package's oracle (f2 at 24 blocks); at f2048 the orbit also against
    the JAX render."""
    db, tdb = _dbs(name)
    pos, cb, opts = RENDERS[case]
    if name == "f2":
        pos, cb = pos[:24], 8
    if case == "gather":  # the orbit's filters overflow the one-hot gate
        monkeypatch.setattr(jfs, "MAX_ONEHOT_U", 4)
        monkeypatch.setattr(tfs, "MAX_ONEHOT_U", 4)
    sig = _signal(len(pos), GEOMETRIES[name][0], 3)
    r = Renderer(tdb, device="cpu", chunk_blocks=cb, **opts)
    got = r.render(sig, pos)
    assert r.dispatch == _jax_arms(db, sig, pos, chunk_blocks=cb, **opts)
    assert len(r.dispatch) == 3
    assert np.abs(got - _oracle(db, sig, pos)).max() <= TOL_JAX
    if case == "orbit" and name == "f2048":
        want, _ = _jax_render(db, sig, pos, (0.0, 0.0), chunk_blocks=cb, fused=True, **opts)
        assert np.abs(got - want).max() <= TOL_JAX


@pytest.mark.parametrize("scene", ["hold", "movers"])
@pytest.mark.parametrize("name", NEW)
def test_batch_renderer_matches_the_oracle_with_the_jax_arms_at_the_new_geometries(name, scene):
    """Two sources of 24 blocks in chunks of 8 (f2: 16 blocks): the hold
    scene's and the movers' arms, each source against the JAX oracle."""
    db, tdb = _dbs(name)
    s, nb = 2, (16 if name == "f2" else 24)
    pos = (bench.scene_hold_positions(s, nb, blocks_per_step=10) if scene == "hold"
           else bench.scene_mover_positions(s, nb))
    fpb = GEOMETRIES[name][0]
    signals = np.stack([_signal(nb, fpb, 7 + i) for i in range(s)])
    jr = JaxBatchRenderer(db, chunk_blocks=8, fused=True)
    arms = []

    def logged(n, **key):
        arms.append(jax_arm(n, **key))
        return lambda *args, **kw: (jnp.zeros((args[1].shape[0], n, fpb, 2), jnp.float32),
                                    args[1])

    jr._get_fn = logged
    jr.render(signals, pos)
    r = BatchRenderer(tdb, device="cpu", chunk_blocks=8)
    got = r.render(signals, pos)
    assert r.dispatch == arms and len(arms) == nb // 8
    for i in range(s):
        assert np.abs(got[i] - _oracle(db, signals[i], pos[i])).max() <= TOL_JAX


@pytest.mark.parametrize("scene", ["hold", "movers"])
@pytest.mark.parametrize("name", RENDERED)
def test_batch_renderer_matches_jax_at_each_geometry(name, scene):
    """Two sources of 24 blocks in chunks of 8: the hold scene's and the
    movers' arms, the unfused chain at a history of partial blocks."""
    db, tdb = _dbs(name)
    s, nb = 2, 24
    pos = (bench.scene_hold_positions(s, nb, blocks_per_step=10) if scene == "hold"
           else bench.scene_mover_positions(s, nb))
    fpb = GEOMETRIES[name][0]
    signals = np.stack([_signal(nb, fpb, 7 + i) for i in range(s)])
    jr = JaxBatchRenderer(db, chunk_blocks=8, fused=True)
    jax_arms = record_jax_arms(jr)
    want = jr.render(signals, pos)
    r = BatchRenderer(tdb, device="cpu", chunk_blocks=8)
    got = r.render(signals, pos)
    assert r.dispatch == jax_arms and len(jax_arms) == 3
    assert np.abs(got - want).max() <= TOL_JAX


@pytest.mark.parametrize("name", RENDERED + NEW)
def test_streaming_forms_match_jax_at_each_geometry(name):
    """``render_scan`` in chunks, and ``StreamingSpatializer`` moving and
    held, at pipeline latency 0 and 1, against the JAX stream."""
    db, tdb = _dbs(name)
    fpb = GEOMETRIES[name][0]
    pos = CircularOrbit(period_s=0.3, ele=8, r=0.9).sample(24, tdb.config)
    sig = _signal(24, fpb, 5)
    got = tstream.render_scan(sig, tdb, pos, tdb.config, device="cpu", chunk_blocks=7)
    want = np.asarray(jstream.render_scan(sig, db, pos, db.config))
    assert np.abs(got - want).max() <= TOL_JAX
    for latency in (0, 1):
        port = tstream.StreamingSpatializer(tdb, pipeline_latency=latency, device="cpu")
        jax = jstream.StreamingSpatializer(db, db.config, pipeline_latency=latency)
        port.buf = jax.buf = sig
        for b in range(12):
            if b in (0, 3, 4):
                for sp in (port, jax):
                    sp.set_position(azi=40.0 * b + 10, ele=5.0 * b, r=0.5 + 0.1 * b)
            assert np.abs(port.process_next() - jax.process_next()).max() <= TOL_JAX
        assert port.crossfades == jax.crossfades == 3


def _pretend_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_the_card_takes_every_named_geometry(name, monkeypatch):
    """The engines' card checks pass at every named geometry (the kernels
    build for it at their first launch)."""
    _, tdb = _dbs(name)
    _pretend_a_card(monkeypatch)
    check_card_geometry(tdb.config)
    assert tstream._stream_device("cuda", tdb.config) == torch.device("cuda", 0)


@pytest.mark.parametrize("fpb,taps", [(16, 512), (128, 3969), (2048, 64)])
def test_the_card_refuses_a_geometry_outside_the_envelope(fpb, taps, monkeypatch):
    """fpb 16 (Q 64 at pad 1024), pad 4096 and fpb 2048, which the card
    once refused, pass its checks: launch A's planes form and launch B take
    them.  What the card still refuses names its resource, before any
    launch: launch B's t-tiles past the grid's y (fpb 2^24)."""
    cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
    assert cfg.frames_per_buffer < 32 or cfg.frames_per_buffer > 1024 or cfg.pad_len > 2048
    assert tfs.card_refusal(fpb, cfg.pad_len) is None
    tfs.check_geometry(fpb, cfg.pad_len)
    check_card_geometry(cfg)
    big = EngineConfig(frames_per_buffer=1 << 24, hrtf_len=taps)
    _, tdb = _dbs("f64")
    tdb = dataclasses.replace(tdb, config=big)
    _pretend_a_card(monkeypatch)
    match = (f"fpb {1 << 24}, pad {big.pad_len}: launch B's 131072 t-tiles of 128 columns "
             f"exceed the 65535 CTAs a grid's y holds")
    before = dict(tfs.launches)
    for make in (lambda: Renderer(tdb, device="cuda"),
                 lambda: tstream.StreamingSpatializer(tdb, big, device="cuda"),
                 lambda: tstream.render_scan(np.zeros(64, np.float32), tdb,
                                             [(0.0, 0.0, 1.0)], big, device="cuda"),
                 lambda: BatchRenderer(tdb, device="cuda")):
        with pytest.raises(ValueError, match=match):
            make()
    assert tfs.launches == before
    with pytest.raises(ValueError, match="pad 1000 is not a power of two"):
        tfs.check_geometry(fpb, 1000)


def test_geometry_forms_follow_the_sources_rules():
    """The forms each named geometry's library has (csrc/fused_forward.cuh;
    the card tests hold the libraries' own report to these)."""
    f = tfs.geometry_forms
    # the split form's layouts (blended rows, pre-blended rows)
    C, P = (tfs.SPLIT_CHUNKED,) * 2, (tfs.SPLIT_PIPE,) * 2
    W = (tfs.SPLIT_PIPE, tfs.SPLIT_CHUNKED)
    assert f(128, 1024) == tfs.Forms(128, 1024, 513, 8, 9, True, True, True, True, True, 128, C)
    assert f(64, 1024) == tfs.Forms(64, 1024, 513, 16, 1, True, True, False, False, True, 64, C)
    assert f(256, 1024) == tfs.Forms(256, 1024, 513, 4, 5, True, True, False, False, True, 128, W)
    assert f(512, 1024) == tfs.Forms(512, 1024, 513, 2, 0, True, True, False, False, True, 128, W)
    assert f(1024, 2048) == tfs.Forms(1024, 2048, 1025, 2, 0, True, True, False, False, True, 128, W)
    assert f(64, 512) == tfs.Forms(64, 512, 257, 8, 9, True, True, False, False, True, 64, C)
    assert f(100, 1024) == tfs.Forms(100, 1024, 513, 0, 0, False, True, False, False, False, 128, C)
    assert f(441, 1024) == tfs.Forms(441, 1024, 513, 0, 0, False, True, False, False, False, 128, W)
    assert f(32, 64) == tfs.Forms(32, 64, 33, 2, 15, False, False, False, False, True, 32)
    # past the old envelope: the tile form to Q 16, the product form to Q
    # 64, the split form to 16 blocks (2,049 bins; 4-byte basis copies past
    # fpb 128, whole float4 columns below it)
    assert f(16, 1024) == tfs.Forms(16, 1024, 513, 64, 0, False, True, False, False, False, 16, C)
    assert f(4, 1024) == tfs.Forms(4, 1024, 513, 256, 0, False, True, False, False, False, 4, C)
    assert f(2, 1024) == tfs.Forms(2, 1024, 513, 512, 0, False, False, False, False, False, 2)
    assert f(2048, 4096) == tfs.Forms(2048, 4096, 2049, 2, 0, True, True, False, False, True, 128, P)
    assert f(128, 4096) == tfs.Forms(128, 4096, 2049, 32, 0, True, True, False, False, False, 128, C)
    assert f(32, 4096).product is False and f(32, 2048).product is True
    # the choices among them
    assert tfs.forward_form(1, 64, 1024) == tfs.FWD_FEW
    assert tfs.forward_form(2, 64, 1024) == tfs.FWD_PRODUCT
    assert tfs.forward_form(1, 1024, 2048) == tfs.FWD_PRODUCT
    assert tfs.forward_form(16, 32, 64) == tfs.FWD_TILE
    for geo in ((16, 1024), (4, 1024), (2, 1024), (32, 4096)):
        assert tfs.forward_form(1, *geo) == tfs.forward_form(300, *geo) == tfs.FWD_RING
    assert tfs.forward_form(1, 128, 4096) == tfs.FWD_PRODUCT == tfs.forward_form(1, 2048, 4096)
    assert tfs.pick_form("fused_step_xfade", 64, 2048, 4096) == tfs.SPLIT
    assert tfs.pick_form("fused_step_xfade", 64, 4, 1024) == tfs.SPLIT
    assert tsp.pick_form(1, 64, 1024) == tsp.SPLIT == tsp.pick_form(1, 100, 1024)
    assert tsp.pick_form(1, 441, 1024) == tfs.SPLIT
    assert tsp.pick_form(1) == tsp.CLUSTER
    assert tfs.pick_form(tfs.ROW1, 1 << 20, 64, 1024) == tfs.LAUNCH_B
    assert tfs.pick_form("fused_apply_xfade", 64, 441, 1024) == tfs.SPLIT
    assert tfs.pick_form("fused_apply_xfade", 64, 100, 1024) == tfs.SPLIT
    assert tfs.pick_form("fused_apply_xfade", 64, 2, 1024) == tfs.LAUNCH_B


@pytest.mark.parametrize("fpb,pad,cols", [
    # below 128 a block that divides 128 sets the tile's width
    (64, 1024, 64), (64, 512, 64), (32, 1024, 32), (16, 1024, 16), (8, 1024, 8), (4, 1024, 4),
    (2, 1024, 2), (32, 64, 32),
    # one that does not keeps 128 columns, masked past fpb; so does every fpb from 128
    (100, 1024, 128), (96, 1024, 128), (48, 256, 128), (128, 1024, 128), (441, 1024, 128),
    (256, 1024, 128), (2048, 4096, 128),
])
def test_launch_b_tile_fits_a_block_that_divides_its_columns(fpb, pad, cols):
    """Launch B's and the chunked layout's tile is fpb columns wide where
    fpb divides 128 below it (csrc/fused_forward.cuh T_FIT, T_COLS), else
    128; the t-tiles and the split form's existence do not change."""
    forms = tfs.geometry_forms(fpb, pad)
    assert forms.tile_cols == cols
    assert tfs.card_refusal(fpb, pad) is None
    if cols < tfs.T_TILE:  # the split form's chunked layout takes the same tile
        assert tfs.T_TILE % cols == 0 and forms.split == (fpb % 4 == 0 and pad >= 256)


def test_the_smokes_launch_a_seam_takes_each_steps_forward_operands(monkeypatch):
    """chip_smoke.launch_a_call reads launch A alone on the operands of rows
    1, 5 and 6 (one stream or S streams), in the form the step takes: here
    with the card's entry swapped for the twin, its XD is the step's."""
    smoke = _chip_smoke()
    _, tdb = _dbs("f64")
    cfg = tdb.config
    geo = dict(pad_len=cfg.pad_len, bins=cfg.num_bins, fpb=cfg.frames_per_buffer)
    seen = []

    def forward(*fwd, form, **g):
        seen.append(form)
        return tfs._forward_reference(*fwd, **g)

    monkeypatch.setattr(tfs, "_forward_cuda", forward)
    wl = bench.build_workload(tdb, 2, 4, "cpu")
    cases = [(bench.step_operands(wl, cfg), 8, 4)]
    for what, s_, nb in (("stream", 1, 40), ("scene", 3, 6)):
        fn, args, kw = (bench.stream_step(tdb, "gather", nb, "cpu") if what == "stream"
                        else bench.scene_step(tdb, "gather", s_, nb, "cpu"))
        cases.append(((args, kw), s_ * nb, nb))
    for (args, kw), rows, nb in cases:
        xdr, xdi = smoke.launch_a_call(args, kw, rows, geo)()
        assert xdr.shape == xdi.shape == (rows, cfg.num_bins)
        streams = args[0] if args[0].dim() == 2 else args[0][None]
        want = tfs._forward_reference(streams, nb, *args[1:4], kw.get("dsel"), kw.get("n_dist"),
                                      **geo)
        assert torch.equal(xdr, want[0]) and torch.equal(xdi, want[1])
    assert seen == [tfs.forward_form(4, 64, 1024), tfs.forward_form(40, 64, 1024),
                    tfs.forward_form(6, 64, 1024)]


def test_a_form_the_geometry_lacks_is_refused_before_a_launch(monkeypatch):
    """Naming the cluster form at fpb 64, or the split form at fpb 2 (a
    ragged basis row at one t-tile), raises before the library is loaded."""
    _, tdb = _dbs("f2")
    fn, args, kw = bench.scene_step(tdb, "apply", 1, 8, "cpu", seed=2)
    monkeypatch.setattr(tfs, "_one_device", lambda ops: torch.device("cuda", 0))
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail("loaded a library"))
    with pytest.raises(ValueError, match="split form does not exist at fpb 2,"):
        tfs._cuda(fn, *args, form=tfs.SPLIT, **kw)
    _, tdb64 = _dbs("f64")
    cfg = tdb64.config
    rows = 2
    z = lambda *shape: torch.zeros(shape)
    with pytest.raises(ValueError, match="cluster form does not exist at fpb 64"):
        tsp._cuda(torch.device("cuda", 0), rows, z(3, 4 * cfg.num_bins), None, z(rows, 1),
                  z(rows, cfg.num_bins), z(rows, cfg.num_bins), None, pad_len=cfg.pad_len,
                  bins=cfg.num_bins, fpb=cfg.frames_per_buffer, form=tsp.CLUSTER)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", ["f64", "f256", "f512", "f1024", "f64t256", "f100", "f441",
                                  "f16", "f4", "f2048", "f128t2048"])
def test_full_size_dispatch_matches_jax_at_each_geometry(name, monkeypatch):
    """The arms ``chip_smoke.py``'s phase geometry holds the card to, at
    full size (1,607,168 samples; a 2-s input at f16 and f4): both renderers plan every chunk with
    their chunk programs stubbed out, and take the same arm on every chunk
    of every render; at f64, f256 and f64t256 the 16-source scenes too."""
    from jefferson_tpu_torch.engine import batch as tbatch
    from jefferson_tpu_torch.engine import renderer as trenderer

    smoke = _chip_smoke()
    fpb, taps = smoke.GEOMETRIES[name]
    assert GEOMETRIES.get(name, (fpb, taps)) == (fpb, taps)
    cfg = JaxConfig(frames_per_buffer=fpb, hrtf_len=taps)
    db = synthetic_database(cfg, n_taps=taps, seed=11)
    tdb = database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(cfg))
    stub = lambda spectra, hist, *a, num_blocks, **k: (torch.zeros(num_blocks, fpb, 2), hist)
    for fn in ("_fd_complex_chunk_dedup_fused", "_fd_complex_chunk_onehot",
               "_fd_complex_chunk_onehot_grouped", "_fd_complex_chunk_fused",
               "_fd_complex_chunk_dedup", "_fd_complex_chunk"):
        monkeypatch.setattr(trenderer, fn, stub)
    n = smoke.geometry_samples(tdb.config) // fpb
    sig = np.zeros(n * fpb, np.float32)
    renders = smoke.geometry_renders(bench, tdb.config)
    assert set(renders) == set(smoke.GEO_ARMS[name])
    for what, (pos, cb) in renders.items():
        r = JaxRenderer(db, fused=True, chunk_blocks=cb)
        _stub_jax_renderer(r, fpb)
        jax_arms = []
        for cache, arm_of in _CACHES.items():
            setattr(r, cache, _Recorder(arm_of, jax_arms))
        r.render(sig, pos)
        port = Renderer(tdb, device="cpu", chunk_blocks=cb)
        port.render(sig, pos)
        assert len(pos) == n and port.dispatch == jax_arms, what
        assert set(jax_arms) == {smoke.GEO_ARMS[name][what]}, what
    if name not in smoke.GEO_SCENES:
        return
    for fn in ("batched_chunk_fn_dedup_fused", "batched_chunk_fn_fused", "batched_chunk_fn_dedup",
               "batched_chunk_fn"):
        monkeypatch.setattr(tbatch, fn, lambda cfg, cb, *a, **k: (
            lambda spectra, hists, *args, **kw: (
                torch.zeros(hists.shape[0], cb, cfg.frames_per_buffer, 2), hists)))
    sigs = np.zeros((smoke.SCENE_S, n * fpb), np.float32)
    for scene, pos in smoke.geometry_scenes(bench, tdb.config).items():
        jr = JaxBatchRenderer(db, chunk_blocks=256, fused=True)
        arms = []

        def logged(nb, **key):
            arms.append(jax_arm(nb, **key))
            return lambda *args, **kw: (
                jnp.zeros((args[1].shape[0], nb, fpb, 2), jnp.float32), args[1])

        jr._get_fn = logged
        jr.render(sigs, pos)
        port = BatchRenderer(tdb, device="cpu", chunk_blocks=256)
        port.render(sigs, pos)
        assert port.dispatch == arms and set(arms) == {smoke.GEO_SCENE_ARMS[name][scene]}, scene


def test_the_smoke_names_every_geometry_and_its_libraries():
    """The geometry phase's table holds this file's geometries but f2 (card
    tests only) and f512, every one taken by the card, with the block counts
    of a 1,607,168-sample render (a 2-s input at f16 and f4), and the
    geometry the card refuses for its resource."""
    smoke = _chip_smoke()
    assert set(GEOMETRIES) - {"f2"} <= set(smoke.GEOMETRIES) and "f512" in smoke.GEOMETRIES
    assert "f2" not in smoke.GEOMETRIES
    for name, (fpb, taps) in smoke.GEOMETRIES.items():
        cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
        tfs.check_geometry(fpb, cfg.pad_len)
        assert smoke.geometry_config(name) == cfg
        assert smoke.geometry_samples(cfg) // fpb == {
            64: 25112, 256: 6278, 512: 3139, 1024: 1569, 100: 16071, 441: 3644, 16: 5512,
            4: 22050, 2048: 784, 128: 12556}[fpb]
    for fpb, taps in smoke.GEO_EDGES:
        cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
        with pytest.raises(ValueError, match="CTAs a grid's y holds"):
            tfs.check_geometry(fpb, cfg.pad_len)
    assert smoke.MAIN_GEOMETRY == build.DEFAULT_GEOMETRY
