"""The port's host library (``jefferson_tpu_torch/native``) bit for bit
against the port's NumPy forms and against the JAX package's extension.

The cases mirror tests/test_native.py: the WAV codec at 16, 24 and 32 bits
and float, the playhead stream and overlap-save windows, malformed WAVs,
a mutation fuzz of the decoder, and the plan core (nearest filter,
interpolation set-up, distance phase split) on a dense grid of positions.
``make_plan`` with the library equals ``make_plan`` with the NumPy forms on
small copies of the scene, sweep and mover trajectories.  A failing
compiler raises with its output, and no caller falls back to NumPy.

The JAX extension is built by scripts/build_native.py, as
tests/test_native.py's fixture builds it, in a copy of the two files that
script reads; only the comparisons with it skip if it cannot be built.
"""

import dataclasses
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from jefferson_tpu_torch import bench, native
from jefferson_tpu_torch.config import DEFAULT_CONFIG
from jefferson_tpu_torch.engine import plan as tplan
from jefferson_tpu_torch.hrtf import kemar as tkemar
from jefferson_tpu_torch.io import wavio as twavio
from jefferson_tpu_torch.kernels import build
from jefferson_tpu_torch.ops import filters as tfilters
from jefferson_tpu_torch.trajectory import interpolation as tinterp

ROOT = Path(__file__).resolve().parents[1]
FSVS = DEFAULT_CONFIG.fsvs
WAV_FORMATS = [(16, False), (24, False), (32, False), (32, True), (64, True)]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's extension module, or None when it cannot be built."""
    from jefferson_tpu import native as jnat

    if jnat.HAVE_NATIVE:
        return jnat._native
    root = tmp_path_factory.mktemp("jax_native")
    for rel in ("scripts/build_native.py", "jefferson_tpu/native/_native.cpp"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, root / rel)
    built = subprocess.run([sys.executable, str(root / "scripts" / "build_native.py")],
                           capture_output=True, text=True)
    found = list((root / "jefferson_tpu" / "native").glob("_jefferson_native*"))
    if built.returncode != 0 or not found:
        return None
    spec = importlib.util.spec_from_file_location("_jefferson_native", found[0])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jnat(jax_native):
    if jax_native is None:
        pytest.skip("the JAX package's extension cannot be built here")
    return jax_native


def _equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _samples(seed, frames=3001, channels=2, lo=-0.9, hi=0.9):
    rng = np.random.default_rng(seed)
    return (rng.random((frames, channels)) * (hi - lo) + lo).astype(np.float32)


# ---- the WAV codec ------------------------------------------------------------

@pytest.mark.parametrize("bits,float_format", WAV_FORMATS)
def test_decode_matches_numpy(tmp_path, bits, float_format):
    x = _samples(bits)
    p = tmp_path / "t.wav"
    twavio.write_wav(p, x, 44100, bits=bits, float_format=float_format)
    got, sr = native.decode_wav(p.read_bytes())
    want, wsr = twavio._read_wav_numpy(p)
    assert sr == wsr == 44100
    _equal(got, want)
    main, _ = twavio.read_wav(p)  # float32 reads take the library
    _equal(main, want)


@pytest.mark.parametrize("bits,float_format", WAV_FORMATS)
def test_decode_matches_the_jax_extension(tmp_path, jnat, bits, float_format):
    x = _samples(bits + 1, frames=777, channels=1)
    p = tmp_path / "t.wav"
    twavio.write_wav(p, x, 48000, bits=bits, float_format=float_format)
    got, sr = native.decode_wav(p.read_bytes())
    want, wsr = jnat.decode_wav(p.read_bytes())
    assert sr == wsr == 48000
    _equal(got, want)


def test_decode_reads_8_bit_and_extensible_wavs():
    """Unsigned 8-bit PCM, and WAVE_FORMAT_EXTENSIBLE's tag in its SubFormat."""
    import struct

    def wav(fmt_body, data):
        body = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
        body += b"data" + struct.pack("<I", len(data)) + data
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body

    data8 = bytes(range(256))
    x, sr = native.decode_wav(wav(struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8), data8))
    _equal(x[:, 0], ((np.arange(256) - 128.0) / 128.0).astype(np.float32))
    pcm = np.arange(-6, 6, dtype="<i2").tobytes()
    ext = struct.pack("<HHIIHHHHI", 0xFFFE, 2, 44100, 0, 4, 16, 22, 16, 3) + struct.pack(
        "<H", 1) + b"\x00" * 14
    x, _ = native.decode_wav(wav(ext, pcm))
    _equal(x, (np.arange(-6, 6) / 32768.0).astype(np.float32).reshape(6, 2))


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("shape", [(500, 2), (333,)])
def test_encode_matches_numpy(bits, shape):
    x = _samples(bits, frames=500, lo=-1.2, hi=1.2)  # past full scale: clipped
    x = x.reshape(-1)[: int(np.prod(shape))].reshape(shape)
    x[0] = 0.5 / (1 << (bits - 1))  # a tie: rounds half to even
    got = native.encode_pcm(x, bits)
    assert got == twavio._encode_numpy(x, bits, False)
    assert twavio._encode(x, bits, False) == got  # float32 PCM takes the library


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_encode_matches_the_jax_extension(jnat, bits):
    x = _samples(bits + 7, frames=640, lo=-1.3, hi=1.3)
    assert native.encode_pcm(x, bits) == jnat.encode_pcm(x, bits)


def test_encode_keeps_float64_and_float_output_on_numpy():
    """Float64 samples and IEEE float output never reach the library, as in
    the JAX module: its float32 quantizer would flip ties of float64 data."""
    x = _samples(5, frames=64).astype(np.float64)
    assert twavio._encode(x, 24, False) == twavio._encode_numpy(x, 24, False)
    assert twavio._encode(x, 32, True) == x.astype("<f4").tobytes()


def test_fed_stream_and_segments_match_numpy():
    s = np.arange(777, dtype=np.float32)
    f = native.fed_stream(s, 20, 128)
    _equal(f, np.tile(s, 5)[: 20 * 128])
    hist = np.linspace(-1, 1, 896).astype(np.float32)
    seg = native.build_segments(f, hist, 128, 1024)
    full = np.concatenate([hist, f])
    _equal(seg, full[np.arange(20)[:, None] * 128 + np.arange(1024)[None, :]])
    _equal(native.build_segments(f[:0], hist, 128, 1024), np.zeros((0, 1024), np.float32))
    for n in (1, 127, 128, 2559, 2560, 5000):
        sig = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        _equal(tplan.fed_stream(sig, 20), tplan._fed_stream_numpy(sig, 20))


def test_fed_stream_and_segments_match_the_jax_extension(jnat):
    s = np.arange(1001, dtype=np.float32) * 0.5
    _equal(native.fed_stream(s, 33, 96), jnat.fed_stream(s, 33, 96))
    hist = np.linspace(-2, 2, 928).astype(np.float32)
    f = native.fed_stream(s, 33, 96)
    _equal(native.build_segments(f, hist, 96, 1024), jnat.build_segments(f, hist, 96, 1024))


@pytest.mark.parametrize("data", [
    b"RIFFxxxxWAVEjunkjunk",                                  # no fmt, no data
    b"",
    b"RIFF\x00\x00\x00\x00WAVEfmt \x10\x00\x00\x00" + b"\x01\x00\x00\x00" + b"\x00" * 12
    + b"data\x00\x00\x00\x00",                                # channels = 0
    b"RIFF\x00\x00\x00\x00WAVEfmt \x10\x00\x00\x00" + b"\x01\x00\x01\x00" + b"\x00" * 10
    + b"\x04\x00data\x00\x00\x00\x00",                        # 4-bit PCM
    b"RIFF\x00\x00\x00\x00WAVEfmt \x10\x00\x00\x00" + b"\x07\x00\x01\x00" + b"\x00" * 10
    + b"\x10\x00data\x00\x00\x00\x00",                        # format tag 7
])
def test_malformed_wav_raises(data):
    with pytest.raises(ValueError):
        native.decode_wav(data)


def test_bad_sizes_raise():
    with pytest.raises(ValueError, match="bits"):
        native.encode_pcm(np.zeros(4, np.float32), 8)
    with pytest.raises(ValueError, match="empty"):
        native.fed_stream(np.zeros(0, np.float32), 4, 128)
    with pytest.raises(ValueError, match="sizes"):
        native.build_segments(np.zeros(256, np.float32), np.zeros(10, np.float32), 128, 1024)
    with pytest.raises(ValueError, match="sizes"):
        native.build_segments(np.zeros(200, np.float32), np.zeros(896, np.float32), 128, 1024)
    with pytest.raises(ValueError, match="size mismatch"):
        native.pick_hrtf(np.zeros(3, np.float32), np.zeros(2, np.float32))


_FUZZ_BASE = (twavio._header(44100, 2, 16, False, 64 * 2 * 2)
              + twavio._encode_numpy(_samples(99, frames=64) - 0.5, 16, False))


@settings(max_examples=400, deadline=None, derandomize=True, database=None,
          suppress_health_check=list(HealthCheck))
@given(edits=st.lists(st.tuples(st.integers(0, len(_FUZZ_BASE) - 1), st.integers(0, 255)),
                      min_size=1, max_size=6),
       cut=st.one_of(st.none(), st.integers(0, len(_FUZZ_BASE))))
def test_decode_mutation_fuzz_does_not_crash(edits, cut):
    """Mutated and truncated WAVs either decode to (frames, channels) float32
    or raise ValueError; nothing reads out of bounds."""
    b = bytearray(_FUZZ_BASE)
    for pos, val in edits:
        b[pos] = val
    if cut is not None:
        b = b[:cut]
    try:
        x, sr = native.decode_wav(bytes(b))
    except ValueError:
        return
    assert x.dtype == np.float32 and x.ndim == 2 and x.shape[1] >= 1 and sr >= 0


# ---- the plan core ------------------------------------------------------------

def _grid():
    """Every half degree of elevation -60..110 against every half degree of
    azimuth -30..400 (halves, ties between grid azimuths, negatives, 360 and
    above, the poles and beyond), then fractions, float32 values an ulp
    below a .5 boundary, and random positions."""
    e, a = np.meshgrid(np.arange(-60, 110.5, 0.5), np.arange(-30, 400.5, 0.5), indexing="ij")
    rng = np.random.default_rng(7)
    ele = np.concatenate([e.ravel(), rng.uniform(-50, 100, 4000), [0.49999997, -0.49999997,
                          89.99999, 90.0, -40.0, 4.9999995, 95.0, -45.0]]).astype(np.float32)
    azi = np.concatenate([a.ravel(), rng.uniform(-20, 380, 4000), [354.5, 0.49999997, 359.5,
                          360.0, 720.0, -0.5, 2.4999998, 3.2150002]]).astype(np.float32)
    return ele, azi


def _radii():
    rng = np.random.default_rng(8)
    return np.concatenate([rng.uniform(0.001, 12.0, 5000), np.geomspace(1e-6, 1e3, 200),
                           [0.0, 0.5, 1.0, 1.0 / DEFAULT_CONFIG.distance_scale]]).astype(np.float32)


def test_pick_hrtf_matches_numpy():
    ele, azi = _grid()
    _equal(tkemar.pick_hrtf(ele, azi), tkemar._pick_hrtf_numpy(ele, azi))
    m = (ele[:600].reshape(20, 30), azi[:30].reshape(1, 30))  # broadcast, 2-D
    _equal(tkemar.pick_hrtf(*m), tkemar._pick_hrtf_numpy(*m))
    assert tkemar.pick_hrtf(10.0, 354.0) == tkemar._pick_hrtf_numpy(10.0, 354.0)
    assert np.ndim(tkemar.pick_hrtf(10.0, 354.0)) == 0


def test_interpolation_calculations_match_numpy():
    ele, azi = _grid()
    for args in ((ele, azi), (ele[:70].reshape(7, 10), azi[:10]), (12.0, 354.0),
                 (np.float32(-35.5), np.float32(359.5))):
        got = tinterp.interpolation_calculations(*args)
        want = tinterp._interpolation_calculations_numpy(*args)
        for f in ("indices", "weights", "omegas", "case"):
            _equal(getattr(got, f), getattr(want, f), f)


def test_distance_phase_split_matches_numpy():
    r = _radii()
    for fsvs, bins in ((FSVS, 513), (48000 / 343.0, 513), (FSVS, 129)):
        for g, w in zip(tfilters.distance_phase_split(fsvs, r, bins),
                        tfilters._distance_phase_split_numpy(fsvs, r, bins)):
            _equal(g, w)
    # radii that are not 1-D take the NumPy form, as in the JAX module
    r2 = r[:12].reshape(3, 4)
    for g, w in zip(tfilters.distance_phase_split(FSVS, r2, 513),
                    tfilters._distance_phase_split_numpy(FSVS, r2, 513)):
        _equal(g, w)


def test_plan_core_matches_the_jax_extension(jnat):
    ele, azi = _grid()
    _equal(native.pick_hrtf(ele, azi), jnat.pick_hrtf(ele, azi))
    for g, w, what in zip(native.interp_plan(ele, azi), jnat.interp_plan(ele, azi),
                          ("indices", "weights", "omegas", "case")):
        _equal(g, w, what)
    r = _radii()
    for g, w in zip(native.distance_phase_split(FSVS, r, 513),
                    jnat.distance_phase_split(FSVS, r, 513)):
        _equal(g, w)


_TRAJECTORIES = {
    "scene_hold": lambda: bench.scene_hold_positions(4, 300),
    "scene_movers": lambda: bench.scene_mover_positions(4, 300),
    "wide": lambda: bench.wide_positions(4, 300),
    "sweep": lambda: bench.sweep_positions(3.0, 5.0)[:1500][None],
    "mover": lambda: bench.mover_positions(1500)[None],
    "helix": lambda: bench.helix_positions(1500)[None],
}


@pytest.mark.parametrize("name", list(_TRAJECTORIES))
@pytest.mark.parametrize("initial_old", [(0.0, 0.0), None])
def test_make_plan_matches_the_numpy_forms(name, initial_old):
    for pos in _TRAJECTORIES[name]():
        got = tplan.make_plan(pos, DEFAULT_CONFIG, initial_old)
        with bench.plain_host():
            assert tplan.pick_hrtf is tkemar._pick_hrtf_numpy
            want = tplan.make_plan(pos, DEFAULT_CONFIG, initial_old)
        assert tplan.pick_hrtf is tkemar.pick_hrtf
        for f in dataclasses.fields(got):
            _equal(getattr(got, f.name), getattr(want, f.name), f.name)


# ---- the build ----------------------------------------------------------------

def _broken(monkeypatch, tmp_path, compiler):
    monkeypatch.setattr(native, "TOOLCHAIN", dataclasses.replace(native.TOOLCHAIN,
                                                                 compiler=compiler))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")


def test_a_failing_compiler_raises_with_its_output(tmp_path, monkeypatch):
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\necho \"cc: cannot build $*\" >&2\nexit 3\n")
    cc.chmod(0o755)
    _broken(monkeypatch, tmp_path, str(cc))
    with pytest.raises(RuntimeError, match=r"(?s)failed on native/native.cpp \(exit 3\).*"
                                           r"cc: cannot build .*-ffp-contract=off"):
        native.library()
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("compiler,match", [("false", r"false failed on native/native.cpp"),
                                            ("no-such-compiler-here", "not found")])
def test_no_caller_falls_back_to_numpy(tmp_path, monkeypatch, compiler, match):
    """With the build failing, every caller of the library raises."""
    _broken(monkeypatch, tmp_path, compiler)
    wav = tmp_path / "t.wav"  # float64 samples: written by the NumPy quantizer
    twavio.write_wav(wav, _samples(1, frames=16).astype(np.float64), 44100, bits=16)
    calls = [
        lambda: tkemar.pick_hrtf(10.0, 20.0),
        lambda: tinterp.interpolation_calculations(10.0, 20.0),
        lambda: tfilters.distance_phase_split(FSVS, np.ones(3, np.float32), 513),
        lambda: tplan.fed_stream(np.ones(5, np.float32), 4),
        lambda: tplan.make_plan(np.zeros((4, 3)), DEFAULT_CONFIG),
        lambda: twavio.read_wav(wav),
        lambda: twavio._encode(np.zeros(4, np.float32), 24, False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match=match):
            call()


def test_the_library_is_keyed_by_its_source_compiler_and_flags():
    path = build.library_path("native", native.TOOLCHAIN)
    assert path.parent == build.BUILD_DIR and path.name.startswith("native-")
    assert [p.name for p in build.sources("native", native.TOOLCHAIN)] == ["native.cpp"]
    assert "-ffp-contract=off" in native.TOOLCHAIN.flags
    for change in ({"compiler": "clang++"}, {"flags": native.TOOLCHAIN.flags[:-1]}):
        assert build.library_path("native", dataclasses.replace(native.TOOLCHAIN,
                                                                **change)) != path
    assert build.library_path("fused_step_onehot") != build.library_path(
        "fused_step_onehot", dataclasses.replace(build.cuda(), flags=()))
