"""NumPy float32 oracle of the interpolating render: a copy of the parts of
``jefferson_tpu/oracle/reference.py`` that hold the port's ``-t 0`` path
(``render_oracle`` with the FD_COMPLEX block process), the parity anchor of
both packages (reference: Jefferson/src/CPUSoundSource.cpp,
Jefferson/src/functions.cpp).

FFT convention: like FFTW's R2C, scipy's rfft is unnormalized; the
reference scales the forward spectrum by 1/pad_len (CPUSoundSource.cpp:119,
280) and scipy's irfft carries a 1/N that FFTW's C2R does not, so the
inverse is multiplied by pad_len.  ``tests/test_torch_hosts.py`` pins this
copy to the original.
"""

from __future__ import annotations

import numpy as np
import scipy.fft

from ..config import DEFAULT_CONFIG, EngineConfig
from ..hrtf.kemar import HRTFDatabase, round_half_away
from ..trajectory.interpolation import interpolation_calculations
from ..trajectory.spatial import radius_from_cartesian, spherical_to_cartesian

_F32 = np.float32
_C64 = np.complex64


def distance_factor(coordinates: np.ndarray, config: EngineConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Distance cue R[k] = e^{-j 2π (fs/vs) r k / N} / (1 + (fs/vs) r²) for
    one position, r = |coords|/5 and N = num_bins (the reference's
    half-spectrum size, CPUSoundSource.cpp:43-48) -> (num_bins,) complex64."""
    r = _F32(radius_from_cartesian(coordinates))
    r = _F32(r / _F32(config.distance_scale))
    fsvs = _F32(config.fsvs)
    frac = _F32(1.0 + float(fsvs) * float(r) ** 2)
    n = config.num_bins
    k = np.arange(n, dtype=np.float64)
    arg = 2.0 * np.pi * float(fsvs) * float(r) * k / n
    return ((np.cos(arg) - 1j * np.sin(arg)) / float(frac)).astype(_C64)


def _complex_scale(a: np.ndarray, s: float) -> np.ndarray:
    """complexScaling (reference: Jefferson/src/functions.cpp:34-40), float32."""
    return (a * _F32(s)).astype(_C64)


def interpolate_loops(spec2, db: HRTFDatabase, indices, omegas, df):
    """The reference's four interpolation cases (CPUSoundSource.cpp:143-273)."""
    i0, i1, i2, i3 = indices

    def product(i):
        return (spec2 * db.spectra[indices[i]]).astype(_C64)

    if i0 == i1 and i1 == i2 and i2 == i3:  # case one
        return (product(0) * df[None, :]).astype(_C64)
    if i0 == i2 or i0 == i1:  # case two (azimuth only), case three (elevation only)
        j, wa, wb = (1, omegas[1], omegas[0]) if i0 == i2 else (2, omegas[5], omegas[4])
        cb0 = (_complex_scale(product(0), wa) * df[None, :]).astype(_C64)
        cb1 = (_complex_scale(product(j), wb) * df[None, :]).astype(_C64)
        return (cb0 + cb1).astype(_C64)
    w = [  # case four, the full bilinear blend
        _F32(omegas[5]) * _F32(omegas[1]),
        _F32(omegas[5]) * _F32(omegas[0]),
        _F32(omegas[4]) * _F32(omegas[3]),
        _F32(omegas[4]) * _F32(omegas[2]),
    ]
    cbs = [_complex_scale((product(i) * df[None, :]).astype(_C64), w[i]) for i in range(4)]
    out = (cbs[0] + cbs[1]).astype(_C64)
    out = (out + cbs[2]).astype(_C64)
    return (out + cbs[3]).astype(_C64)


def _fd_interpolate(x, db, config, azi, ele, coords, old_azi, old_ele) -> np.ndarray:
    """One block of the interpolating path with crossfade -> (fpb, 2)
    float32 (reference: CPUSoundSource.cpp:274-339)."""
    spec = _complex_scale(scipy.fft.rfft(x).astype(_C64), 1.0 / config.pad_len)
    spec2 = np.stack([spec, spec])

    def inverse(s2):
        y = scipy.fft.irfft(s2, axis=-1).astype(_F32) * _F32(config.pad_len)
        return y.T[config.history_len :]

    c = interpolation_calculations(ele, azi)
    df = distance_factor(coords, config)
    y_new = inverse(interpolate_loops(spec2, db, c.indices[0], c.omegas[0], df))
    if old_azi == azi and old_ele == ele:
        return y_new
    oc = interpolation_calculations(old_ele, old_azi)
    y_old = inverse(interpolate_loops(spec2, db, oc.indices[0], oc.omegas[0], df))
    fn = (np.arange(config.frames_per_buffer, dtype=_F32)
          / _F32(config.frames_per_buffer - 1.0))[:, None]
    return (y_old * (_F32(1.0) - fn) + y_new * fn).astype(_F32)


def render_oracle(
    signal: np.ndarray,
    db: HRTFDatabase,
    positions,
    config: EngineConfig = DEFAULT_CONFIG,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
) -> np.ndarray:
    """Interpolating render, block by block like the reference's audio
    callback (reference: Jefferson/src/Audio.cu:119-157) -> (B*fpb, 2).

    ``positions``: per-block (azi_deg, ele_deg, r), applied as the
    reference's updateFromSpherical before each block; the input wraps when
    exhausted.  ``initial_old``: the crossfade state before block 0; (0, 0)
    is the reference's SoundSource constructor, None seeds it with the first
    position so block 0 does not crossfade."""
    positions = list(positions)
    fpb = config.frames_per_buffer
    buf = np.asarray(signal, dtype=_F32)
    length = len(buf)
    x = np.zeros(config.pad_len, dtype=_F32)
    if initial_old is None and positions:
        old_azi = _F32(round_half_away(_F32(positions[0][0])))
        old_ele = _F32(round_half_away(_F32(positions[0][1])))
    else:
        old_azi, old_ele = _F32(initial_old[0]), _F32(initial_old[1])
    out = np.zeros((len(positions) * fpb, 2), dtype=_F32)
    count = 0
    for b, (azi, ele, r) in enumerate(positions):
        azi, ele = _F32(round_half_away(_F32(azi))), _F32(round_half_away(_F32(ele)))
        coords = spherical_to_cartesian(azi, ele, _F32(r))
        # the wrapping playhead; buffers shorter than a block tile modularly
        if count + fpb < length:
            x[config.history_len :] = buf[count : count + fpb]
            count += fpb
        else:
            x[config.history_len :] = buf[(count + np.arange(fpb)) % length]
            count = (count + fpb) % length
        out[b * fpb : (b + 1) * fpb] = _fd_interpolate(
            x, db, config, azi, ele, coords, old_azi, old_ele)
        old_azi, old_ele = azi, ele
        x[: config.history_len] = x[fpb:]  # overlap-save
    return out
