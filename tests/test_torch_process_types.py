"""Process types -t 0/1/2 in both transform backends, and the ops under
them, against the JAX package on the CPU.

The stage cases of tests/test_stages.py (the FFT round trip, the distance,
forward, blend and crossfade stages, ``blend_channel``) run on the port's
ops and against the jnp ops on the same inputs.  The renders run through
``Renderer(device="cpu")`` and the JAX ``Renderer`` on the same inputs, and
against ``render_oracle``, at tests/test_engine_parity.py's gates: 1e-6 end
to end (E2E_EPS), 2e-7 for -t 1 in the fft backend, 5e-6 for the backends
against each other and for TD against the gain-scaled CPU oracle, 2e-5 for
TD against FD basic.  The port against the JAX renderer: 5e-7 (fp32 sums in
another order; the port's -t 1 matmul tail is summed by 128-bin blocks).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from jefferson_tpu import ProcessType as P
from jefferson_tpu.engine.renderer import Renderer as JaxRenderer
from jefferson_tpu.ops import fft as jfft
from jefferson_tpu.ops import filters as jfilters
from jefferson_tpu.oracle.reference import render_oracle
from jefferson_tpu.testing import precision_check
from jefferson_tpu.trajectory.trajectory import CircularOrbit, StaticPosition
from jefferson_tpu_torch.config import EngineConfig as TConfig
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.ops import fft as tfft
from jefferson_tpu_torch.ops import filters as tfilters
from jefferson_tpu_torch.oracle.reference import (
    OracleSpatializer,
    distance_factor,
    interpolate_loops,
)
from jefferson_tpu_torch.trajectory.interpolation import interpolation_calculations
from jefferson_tpu_torch.trajectory.spatial import spherical_to_cartesian

torch.set_num_threads(1)

E2E_EPS = 1e-6
FFT_BASIC_EPS = 2e-7
BACKENDS_EPS = 5e-6
TD_EPS = 5e-6
TD_FD_EPS = 2e-5
TOL_JAX = 5e-7
ENGINE = (P.TPU_FD_COMPLEX, P.TPU_FD_BASIC, P.TPU_TD)


@pytest.fixture(scope="module")
def tdb(db):
    """The port's database, carried across from the JAX fixture."""
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _c64(a):
    return np.asarray(a).astype(np.complex64).view(np.float32)


# ---- stages -------------------------------------------------------------------


def test_fft_roundtrip_sanity(config):
    """Known sinusoids through both of the port's backends, against scipy
    and the JAX backends."""
    n = config.pad_len
    t = np.arange(n)
    for freq in [1, 7, 128, 511]:
        x = np.sin(2 * np.pi * freq * t / n).astype(np.float32)
        for backend in ["fft", "matmul"]:
            rfft, irfft = tfft.get_backend(backend)
            jr, ji = jfft.get_backend(backend)
            spec = rfft(_t(x), n)
            assert spec.dtype == torch.complex64
            # XLA's CPU FFT is bit-exact to scipy here (the original's 1e-6);
            # torch.fft on the CPU rounds otherwise, a few ulps of the
            # 512-magnitude bins, as the matmul backend's fp32 sums do
            eps = 2e-4 if backend == "matmul" else 1e-4
            want = scipy.fft.rfft(x)
            assert precision_check(_c64(spec.numpy()), _c64(want), eps=eps).ok
            assert precision_check(_c64(spec.numpy()), _c64(jr(jnp.asarray(x), n)), eps=eps).ok
            back = irfft(spec, n).numpy()
            assert precision_check(back, x, eps=1e-5).ok, f"{backend} freq {freq}"
            jback = np.asarray(ji(jnp.asarray(spec.numpy()), n))
            assert precision_check(back, jback, eps=1e-6).ok
    with pytest.raises(ValueError, match="unknown fft backend"):
        tfft.get_backend("dct")


def test_fft_matches_scipy_tight(config):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, config.pad_len)).astype(np.float32)
    spec = tfft.rfft(_t(x)).numpy()
    want = scipy.fft.rfft(x).astype(np.complex64)
    rep = precision_check(_c64(spec), _c64(want), eps=1e-4)
    assert rep.ok, str(rep)
    rep = precision_check(_c64(spec), _c64(jfft.rfft(jnp.asarray(x))), eps=1e-4)
    assert rep.ok, str(rep)


def test_distance_factor_stage(config):
    """The port's complex distance factors against the oracle's float64
    formula and the JAX op, many radii."""
    radii = np.array([0.1, 0.5, 1.0, 2.5, 4.9, 9.7], dtype=np.float32)
    coords = spherical_to_cartesian(np.zeros_like(radii), np.zeros_like(radii), radii)
    want = np.stack([distance_factor(c, TConfig()) for c in coords])
    scaled = np.sqrt((coords**2).sum(-1)).astype(np.float32) / np.float32(config.distance_scale)
    split = tfilters.distance_phase_split(config.fsvs, scaled, config.num_bins)
    got = tfilters.distance_factors(*map(_t, split), config.num_bins)
    assert got.dtype == torch.complex64
    rep = precision_check(_c64(got.numpy()), _c64(want), eps=2e-6)
    assert rep.ok, str(rep)
    jgot = jfilters.distance_factors(*map(jnp.asarray, split), config.num_bins)
    rep = precision_check(_c64(got.numpy()), _c64(jgot), eps=1e-7)
    assert rep.ok, str(rep)


def test_forward_spectrum_stage(tdb, config, castanets):
    sp = OracleSpatializer(tdb, tdb.config)
    sp.buf = castanets
    sp.feed_from_buf()
    want = scipy.fft.rfft(sp.x).astype(np.complex64)
    got = tfft.rfft(_t(sp.x)).numpy()
    rep = precision_check(_c64(got), _c64(want), eps=1e-4)
    assert rep.ok, str(rep)
    rep = precision_check(_c64(got), _c64(jfft.rfft(jnp.asarray(sp.x))), eps=1e-4)
    assert rep.ok, str(rep)


@pytest.mark.parametrize("ele,azi", [(0, 0), (0, 3), (5, 0), (5, 3), (-35, 7), (43, 119)])
def test_filter_blend_stage(tdb, db, ele, azi):
    """blend_filters (complex) and blend_filters_split (planes) against the
    oracle's case chains and the JAX ops, all four cases."""
    cfg = tdb.config
    rng = np.random.default_rng(2)
    spec = (rng.standard_normal(cfg.num_bins)
            + 1j * rng.standard_normal(cfg.num_bins)).astype(np.complex64)
    spec2 = np.stack([spec, spec])
    df = distance_factor(spherical_to_cartesian(azi, ele, 1.3), cfg)
    c = interpolation_calculations(float(ele), float(azi))
    want = interpolate_loops(spec2, tdb, c.indices[0], c.omegas[0], df)
    g = tfilters.blend_filters(_t(tdb.spectra), _t(c.indices), _t(c.weights)).numpy()
    got = spec2 * g[0] * df[None, :]
    rep = precision_check(_c64(got), _c64(want), eps=2e-5)
    assert rep.ok, str(rep)
    jg = np.asarray(jfilters.blend_filters(jnp.asarray(db.spectra), jnp.asarray(c.indices),
                                           jnp.asarray(c.weights)))
    assert precision_check(_c64(g), _c64(jg), eps=TOL_JAX).ok
    gr, gi = tfilters.blend_filters_split(_t(np.real(tdb.spectra).copy()),
                                          _t(np.imag(tdb.spectra).copy()),
                                          _t(c.indices), _t(c.weights))
    jr, ji = jfilters.blend_filters_split(jnp.asarray(np.real(db.spectra)),
                                          jnp.asarray(np.imag(db.spectra)),
                                          jnp.asarray(c.indices), jnp.asarray(c.weights))
    assert precision_check(gr.numpy(), jr, eps=TOL_JAX).ok
    assert precision_check(gi.numpy(), ji, eps=TOL_JAX).ok


def test_crossfade_stage():
    b, frames = 3, 128
    rng = np.random.default_rng(3)
    old = rng.standard_normal((b, 2, frames)).astype(np.float32)
    new = rng.standard_normal((b, 2, frames)).astype(np.float32)
    xf = np.array([True, False, True])
    got = tfilters.crossfade_tails(_t(old), _t(new), _t(xf)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfilters.crossfade_tails(jnp.asarray(old), jnp.asarray(new),
                                                 jnp.asarray(xf))))
    fn = np.arange(frames, dtype=np.float32) / np.float32(frames - 1)
    np.testing.assert_allclose(got[0], old[0] * (1 - fn) + new[0] * fn, atol=1e-7)
    np.testing.assert_array_equal(got[1], new[1])
    assert got[0, 0, 0] == old[0, 0, 0]


def test_blend_channel_reference_shape_matches_einsum():
    rng = np.random.default_rng(11)
    table = rng.standard_normal((32, 17)).astype(np.float32)
    idx = rng.integers(0, 32, size=(6, 4)).astype(np.int32)
    w = rng.random((6, 4), dtype=np.float32)
    got = tfilters.blend_channel(_t(table), _t(idx), _t(w)).numpy()
    np.testing.assert_allclose(got, np.einsum("bk,bkf->bf", w, table[idx]), atol=1e-6)
    # the same brackets added in the same order as the JAX op
    np.testing.assert_array_equal(
        got, np.asarray(jfilters.blend_channel(jnp.asarray(table), jnp.asarray(idx),
                                               jnp.asarray(w))))


def test_matmul_transforms_match_jax(config):
    n = config.pad_len
    x = np.random.default_rng(4).standard_normal((5, n)).astype(np.float32) * 0.2
    got = tfft.rfft_matmul(_t(x), n)
    want = np.asarray(jfft.rfft_matmul(jnp.asarray(x), n))
    assert precision_check(_c64(got.numpy()), _c64(want), eps=2e-5).ok
    back = tfft.irfft_matmul(got, n).numpy()
    jback = np.asarray(jfft.irfft_matmul(jnp.asarray(got.numpy()), n))
    assert precision_check(back, jback, eps=1e-6).ok
    assert precision_check(back, x, eps=1e-5).ok


# ---- renders -------------------------------------------------------------------


def _oracle(db, sig, pos, ptype, cfg=None, **kw):
    cfg = cfg or db.config
    return render_oracle(sig, db, [tuple(p) for p in pos], cfg, ptype, **kw)


def _both(tdb, db, sig, pos, ptype, backend="matmul", chunk_blocks=64, cfg=None, **kw):
    """(port render on the CPU, JAX render) of the same inputs."""
    got = Renderer(tdb, cfg, device="cpu", chunk_blocks=chunk_blocks,
                   backend=backend, **kw).render(sig, pos, ptype)
    jcfg = None if cfg is None else type(db.config)(**dataclasses.asdict(cfg))
    want = JaxRenderer(db, jcfg, chunk_blocks=chunk_blocks, backend=backend).render(sig, pos, ptype)
    rep = precision_check(got, want, eps=TOL_JAX)
    assert rep.ok, f"{ptype.name} {backend} vs the JAX Renderer: {rep}"
    return got


@pytest.mark.parametrize("backend", ["matmul", "fft"])
@pytest.mark.parametrize("ptype", ENGINE)
def test_static_source_parity(tdb, db, castanets, ptype, backend):
    pos = StaticPosition(azi=30, ele=10, r=1.5).sample(40, db.config)
    got = _both(tdb, db, castanets, pos, ptype, backend)
    td_gain = db.config.source_gain if ptype == P.TPU_TD else 1.0
    want = _oracle(db, castanets, pos, ptype, td_gain=td_gain)
    rep = precision_check(got, want, eps=E2E_EPS if ptype != P.TPU_TD else TD_EPS)
    assert rep.ok, f"{ptype.name}: {rep}"


@pytest.mark.parametrize("backend", ["matmul", "fft"])
@pytest.mark.parametrize("ptype", ENGINE)
def test_moving_source_parity(tdb, db, castanets, ptype, backend):
    """An orbit moving every block, each process type, against the JAX
    Renderer and the oracle; the dispatch names each chunk's arm."""
    pos = CircularOrbit(period_s=0.8, ele=7, r=2.0).sample(80, db.config)
    r = Renderer(tdb, device="cpu", chunk_blocks=32, backend=backend)
    got = r.render(castanets, pos, ptype)
    want = JaxRenderer(db, chunk_blocks=32, backend=backend).render(castanets, pos, ptype)
    assert precision_check(got, want, eps=TOL_JAX).ok
    td_gain = db.config.source_gain if ptype == P.TPU_TD else 1.0
    rep = precision_check(got, _oracle(db, castanets, pos, ptype, td_gain=td_gain),
                          eps=E2E_EPS if ptype != P.TPU_TD else TD_EPS)
    assert rep.ok, f"{ptype.name} {backend}: {rep}"
    arm = {P.TPU_FD_BASIC: "fd_basic", P.TPU_TD: "td"}.get(ptype)
    if arm is not None:
        assert r.dispatch == [(arm, False, None)] * 3
    elif backend == "fft":
        assert {a for a, _, _ in r.dispatch} == {"plain"}


def test_fd_basic_fft_backend_parity(tdb, db, castanets):
    """-t 1 in the fft backend against the CPU_FD_BASIC oracle at 2e-7
    (PARITY.md row 12)."""
    pos = CircularOrbit(period_s=0.4, ele=10, r=1.0).sample(40, db.config)
    got = _both(tdb, db, castanets, pos, P.TPU_FD_BASIC, "fft", chunk_blocks=40)
    rep = precision_check(got, _oracle(db, castanets, pos, P.CPU_FD_BASIC), eps=FFT_BASIC_EPS)
    assert rep.ok, rep


def test_matmul_backend_matches_fft(tdb, db, castanets):
    pos = CircularOrbit(period_s=1.5).sample(40, db.config)
    a = Renderer(tdb, device="cpu", chunk_blocks=64, backend="fft").render(castanets, pos)
    b = Renderer(tdb, device="cpu", chunk_blocks=64, backend="matmul").render(castanets, pos)
    rep = precision_check(a, b, eps=BACKENDS_EPS)
    assert rep.ok, str(rep)


def test_fft_backend_turns_dedup_and_fused_off(tdb):
    r = Renderer(tdb, device="cpu", backend="fft")
    assert (r.dedup, r.fused, r._spectra.dtype) == (False, False, torch.complex64)
    r = Renderer(tdb, device="cpu")
    assert (r.dedup, r.fused, r.backend) == (True, True, "matmul")
    with pytest.raises(ValueError, match="unknown fft backend"):
        Renderer(tdb, device="cpu", backend="dft")


def test_td_equals_fd_basic_static(tdb, db, castanets):
    """Two disjoint code paths, one linear convolution: TD (gain undone)
    against FD basic with the same nearest filter."""
    pos = StaticPosition(azi=75, ele=-20, r=1.0).sample(24, db.config)
    r = Renderer(tdb, device="cpu", chunk_blocks=64)
    td = r.render(castanets, pos, P.TPU_TD)
    fd = r.render(castanets, pos, P.TPU_FD_BASIC)
    rep = precision_check(td / np.float32(min(db.config.source_gain, 1.0)), fd, eps=TD_FD_EPS)
    assert rep.ok, str(rep)


def test_td_gain_semantics(tdb, db, castanets):
    """The source gain is applied by TD only, clamped at 1 (PARITY.md, "TD
    gain CPU/GPU divergence"), with ``config`` the second positional
    parameter as in the JAX Renderer."""
    cfg = tdb.config
    pos = StaticPosition(azi=30, ele=0, r=1.0).sample(12, cfg)
    td = Renderer(tdb, device="cpu", chunk_blocks=64).render(castanets, pos, P.TPU_TD)
    cpu = _oracle(db, castanets, pos, P.CPU_TD)
    assert np.abs(cpu).max() > 0
    rep = precision_check(td, cpu * np.float32(cfg.source_gain), eps=TD_EPS)
    assert rep.ok, str(rep)
    cfg_hot = dataclasses.replace(cfg, source_gain=1.7)
    td_hot = _both(tdb, db, castanets, pos, P.TPU_TD, chunk_blocks=16, cfg=cfg_hot)
    hot = _oracle(db, castanets, pos, P.CPU_TD, td_gain=1.7)
    assert precision_check(td_hot, hot, eps=TD_EPS).ok
    assert precision_check(td_hot, cpu, eps=TD_EPS).ok  # clamped == unity gain


@pytest.mark.parametrize("backend", ["matmul", "fft"])
@pytest.mark.parametrize("ptype", ENGINE)
def test_chunk_boundary_state_carry(tdb, db, castanets, ptype, backend):
    """The overlap-save history carries across chunks and a ragged last
    chunk (50 blocks in chunks of 7: seven of 7, then 1 padded to 7)."""
    pos = CircularOrbit(period_s=1.0).sample(50, db.config)
    small = Renderer(tdb, device="cpu", chunk_blocks=7, backend=backend)
    a = small.render(castanets, pos, ptype)
    b = Renderer(tdb, device="cpu", chunk_blocks=512, backend=backend).render(castanets, pos, ptype)
    assert len(small.dispatch) == 8
    rep = precision_check(a, b, eps=1e-7)
    assert rep.ok, str(rep)
    want = JaxRenderer(db, chunk_blocks=7, backend=backend).render(castanets, pos, ptype)
    assert precision_check(a, want, eps=TOL_JAX).ok


@pytest.mark.parametrize("ptype", [P.CPU_FD_COMPLEX, P.CPU_FD_BASIC, P.CPU_TD])
def test_cpu_process_types_render_on_the_engine(tdb, castanets, ptype):
    """The CPU_* types take the engine arms of their TPU_* twins, as the
    JAX Renderer does."""
    pos = CircularOrbit(period_s=0.5).sample(20, tdb.config)
    r = Renderer(tdb, device="cpu", chunk_blocks=8)
    np.testing.assert_array_equal(r.render(castanets, pos, ptype),
                                  r.render(castanets, pos, P(ptype - 3)))


def test_td_window_rows_are_bounded(tdb, castanets, monkeypatch):
    """The TD product takes TD_ROWS blocks at a time; the split changes no
    bit of the output."""
    from jefferson_tpu_torch.engine import renderer as R

    pos = CircularOrbit(period_s=0.5).sample(40, tdb.config)
    want = Renderer(tdb, device="cpu", chunk_blocks=40).render(castanets, pos, P.TPU_TD)
    monkeypatch.setattr(R, "TD_ROWS", 3)
    got = Renderer(tdb, device="cpu", chunk_blocks=40).render(castanets, pos, P.TPU_TD)
    np.testing.assert_array_equal(got, want)


def test_irfft_reads_only_the_real_part_of_the_edge_bins():
    """The fft backend's inverse drops the imaginary parts of the DC and
    Nyquist bins, as numpy's and jnp's irfft do, and leaves its input as
    it was."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 513)) + 1j * rng.standard_normal((3, 513))).astype(np.complex64)
    xt = _t(x)
    for n in (1024, 1023):
        got = tfft.irfft(xt, n).numpy()
        assert precision_check(got, np.fft.irfft(x, n), eps=1e-7).ok
        assert precision_check(got, np.asarray(jfft.irfft(jnp.asarray(x), n)), eps=1e-7).ok
    np.testing.assert_array_equal(xt.numpy(), x)
