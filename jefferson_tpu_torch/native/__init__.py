"""The port's host library (``native.cpp``), loaded with ctypes: the WAV
codec, the playhead stream and overlap-save windows, and the plan core
(nearest-filter scan, interpolation set-up, distance phase split).

g++ builds it at first use into ``build/jefferson_tpu_torch/`` through
``kernels/build.py``, keyed by the source, the compiler and the flags.
Unlike the JAX package's ``jefferson_tpu/native``, which falls back to
NumPy when its extension is absent, a failed build raises with the
compiler's output, as the kernels' builds do.  The wrappers keep the JAX
package's names and signatures (``jefferson_tpu/native/__init__.py``); the
callers (``hrtf/kemar.pick_hrtf``,
``trajectory/interpolation.interpolation_calculations``,
``ops/filters.distance_phase_split``, ``engine/plan.fed_stream`` and
``io/wavio``) keep their NumPy forms under private names as the plain
versions, which ``tests/test_torch_native.py`` pins the library to bit for
bit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..kernels import build

# -ffp-contract=off: an FMA-contracted a*b+c (the default where FMA is the
# baseline, as on aarch64) moves 1 + fsvs*r*r and the azimuth scan by an
# ulp against NumPy
TOOLCHAIN = build.Toolchain(
    Path(__file__).resolve().parent, ".cpp", "g++",
    ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"),
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "jtn_wav_header": (_P, _I64, _P, _P, _P),
    "jtn_decode_wav": (_P, _I64, _P, _I64),
    "jtn_encode_pcm": (_P, _I64, ctypes.c_int32, _P),
    "jtn_fed_stream": (_P, _I64, _I64, _I64, _P),
    "jtn_build_segments": (_P, _I64, _P, _I64, _I64, _I64, _P),
    "jtn_pick_hrtf": (_P, _P, _I64, _P),
    "jtn_interp_plan": (_P, _P, _I64, _P, _P, _P, _P),
    "jtn_distance_phase_split": (ctypes.c_double, _P, _I64, _I64, _P, _P, _P),
}

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    if _lib is None:
        lib = build.load("native", TOOLCHAIN)
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib.jtn_error.argtypes, lib.jtn_error.restype = (), ctypes.c_char_p
        _lib = lib
    return _lib


def _call(fn, *args) -> None:
    if fn(*args):
        raise ValueError(library().jtn_error().decode())


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def decode_wav(data: bytes):
    """WAV bytes -> (float32[frames, ch], sample_rate)."""
    lib = library()
    frames, channels, rate = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    _call(lib.jtn_wav_header, data, len(data), ctypes.byref(frames), ctypes.byref(channels),
          ctypes.byref(rate))
    out = np.empty((frames.value, channels.value), dtype=np.float32)
    _call(lib.jtn_decode_wav, data, len(data), out.ctypes.data, out.size)
    return out, rate.value


def encode_pcm(x: np.ndarray, bits: int) -> bytes:
    """float32 samples -> interleaved little-endian PCM 16/24/32 bytes."""
    x = _f32(x)
    if bits not in (16, 24, 32):
        raise ValueError("bits must be 16, 24 or 32")
    out = ctypes.create_string_buffer(x.size * (bits // 8))
    _call(library().jtn_encode_pcm, x.ctypes.data, x.size, bits, out)
    return out.raw


def fed_stream(signal: np.ndarray, num_blocks: int, fpb: int) -> np.ndarray:
    """The signal repeated from its start to num_blocks * fpb samples."""
    signal = _f32(signal)
    out = np.empty(num_blocks * fpb, dtype=np.float32)
    _call(library().jtn_fed_stream, signal.ctypes.data, signal.size, num_blocks, fpb,
          out.ctypes.data)
    return out


def build_segments(stream: np.ndarray, hist: np.ndarray, fpb: int, pad: int) -> np.ndarray:
    """[hist | stream] -> (len(stream) // fpb, pad) overlap-save windows."""
    stream, hist = _f32(stream), _f32(hist)
    out = np.empty((stream.size // fpb if fpb > 0 else 0, pad), dtype=np.float32)
    _call(library().jtn_build_segments, stream.ctypes.data, stream.size, hist.ctypes.data,
          hist.size, fpb, pad, out.ctypes.data)
    return out


def _positions(ele, azi):
    ele, azi = _f32(ele), _f32(azi)
    if ele.size != azi.size:
        raise ValueError("size mismatch")
    return ele, azi


def pick_hrtf(ele: np.ndarray, azi: np.ndarray) -> np.ndarray:
    """Nearest KEMAR filter per position -> int32 (flat)."""
    ele, azi = _positions(ele, azi)
    out = np.empty(ele.size, dtype=np.int32)
    _call(library().jtn_pick_hrtf, ele.ctypes.data, azi.ctypes.data, ele.size, out.ctypes.data)
    return out


def interp_plan(ele: np.ndarray, azi: np.ndarray):
    """interpolationCalculations per position: (idx (B, 4) int32, weights
    (B, 4) float32, omegas (B, 6) float32, case (B,) int8)."""
    ele, azi = _positions(ele, azi)
    b = ele.size
    idx = np.empty((b, 4), dtype=np.int32)
    w = np.empty((b, 4), dtype=np.float32)
    om = np.empty((b, 6), dtype=np.float32)
    case = np.empty(b, dtype=np.int8)
    _call(library().jtn_interp_plan, ele.ctypes.data, azi.ctypes.data, b, idx.ctypes.data,
          w.ctypes.data, om.ctypes.data, case.ctypes.data)
    return idx, w, om, case


def distance_phase_split(fsvs: float, radii: np.ndarray, num_bins: int):
    """(u_hi, u_lo, inv_frac) float32 per radius: the float64-accurate
    12-bit phase split of ``ops/filters``."""
    r = _f32(radii)
    hi, lo, inv = (np.empty(r.size, dtype=np.float32) for _ in range(3))
    _call(library().jtn_distance_phase_split, float(fsvs), r.ctypes.data, r.size, int(num_bins),
          hi.ctypes.data, lo.ctypes.data, inv.ctypes.data)
    return hi, lo, inv
