"""NumPy float32 oracle: a copy of ``jefferson_tpu/oracle/reference.py``'s
``OracleSpatializer`` (the reference's CPUSoundSource, all three process
types) and ``render_oracle``, the parity anchor of both packages
(reference: Jefferson/src/CPUSoundSource.cpp, Jefferson/src/functions.cpp).
The four interpolation cases are written as one function.

FFT convention: like FFTW's R2C, scipy's rfft is unnormalized; the
reference scales the forward spectrum by 1/pad_len (CPUSoundSource.cpp:119,
280) and scipy's irfft carries a 1/N that FFTW's C2R does not, so the
inverse is multiplied by pad_len.  ``tests/test_torch_hosts.py`` pins this
copy to the original.
"""

from __future__ import annotations

import numpy as np
import scipy.fft

from ..config import DEFAULT_CONFIG, EngineConfig, ProcessType
from ..hrtf.kemar import HRTFDatabase, pick_hrtf, round_half_away
from ..trajectory.interpolation import interpolation_calculations
from ..trajectory.spatial import (
    cartesian_to_spherical, radius_from_cartesian, spherical_to_cartesian,
)

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


class OracleSpatializer:
    """Stateful block processor mirroring CPUSoundSource: a copy of the JAX
    package's class.

    Holds the overlap-save buffer ``x`` (pad_len floats, new block written to
    the tail), the playhead ``count`` and crossfade state old_azi/old_ele
    (reference: Jefferson/src/SoundSource.cu:3-16, Jefferson/src/Audio.cu:119-157).
    """

    def __init__(self, db: HRTFDatabase, config: EngineConfig = DEFAULT_CONFIG):
        self.db = db
        self.config = config
        self.x = np.zeros(config.pad_len, dtype=_F32)
        self.azi = _F32(0.0)
        self.ele = _F32(0.0)
        self.r = _F32(0.5)
        self.coordinates = np.array([0.0, 0.0, 0.5], dtype=_F32)
        self.old_azi = self.azi
        self.old_ele = self.ele
        self.count = 0
        self.buf: np.ndarray | None = None
        self.td_gain = 1.0  # CPU TD semantics (see td_convolve docstring)

    # --- position updates (reference: Jefferson/src/SoundSource.cu:20-54) ---
    def update_from_spherical(self, ele=None, azi=None, r=None):
        if ele is not None:
            self.ele = _F32(round_half_away(_F32(ele)))
        if azi is not None:
            self.azi = _F32(round_half_away(_F32(azi)))
        if r is not None:
            self.r = _F32(r)
        self.coordinates = spherical_to_cartesian(self.azi, self.ele, self.r)

    def update_from_cartesian(self, xyz):
        self.coordinates = np.asarray(xyz, dtype=_F32)
        azi, ele, r = cartesian_to_spherical(self.coordinates)
        self.azi, self.ele, self.r = _F32(azi), _F32(ele), _F32(r)

    # --- block feed (reference: Jefferson/src/Audio.cu:119-143) ---
    def feed_block(self, block: np.ndarray) -> None:
        fpb = self.config.frames_per_buffer
        assert block.shape == (fpb,)
        self.x[self.config.history_len :] = block.astype(_F32)

    def feed_from_buf(self) -> None:
        """Pull the next block from the wrapping playback buffer ``self.buf``;
        buffers shorter than one block tile modularly (the reference's
        ``% length`` playhead, Audio.cu:121-139, generalized)."""
        fpb = self.config.frames_per_buffer
        length = len(self.buf)
        if self.count + fpb < length:
            blk = self.buf[self.count : self.count + fpb]
            self.count += fpb
        else:
            blk = self.buf[(self.count + np.arange(fpb)) % length]
            self.count = (self.count + fpb) % length
        self.feed_block(blk)

    def overlap_save(self) -> None:
        fpb = self.config.frames_per_buffer
        self.x[: self.config.history_len] = self.x[fpb:]

    # --- DSP paths ---
    def _forward_spectrum(self) -> np.ndarray:
        """rfft(x) * (1/pad_len), duplicated for both channels -> (2, bins) c64."""
        spec = scipy.fft.rfft(self.x).astype(_C64)
        spec = _complex_scale(spec, 1.0 / self.config.pad_len)
        return np.stack([spec, spec])

    def _inverse(self, spec2: np.ndarray) -> np.ndarray:
        """Unnormalized C2R of both channels -> (pad_len, 2) float32 interleaved."""
        y = scipy.fft.irfft(spec2, axis=-1).astype(_F32) * _F32(self.config.pad_len)
        return y.T.copy()

    def fd_interpolate(self) -> np.ndarray:
        """Full interpolating path with crossfade -> (frames, 2) float32.
        (reference: Jefferson/src/CPUSoundSource.cpp:274-339)"""
        cfg = self.config
        spec2 = self._forward_spectrum()
        coeffs = interpolation_calculations(self.ele, self.azi)
        idx, omg = coeffs.indices[0], coeffs.omegas[0]
        xfade = (self.old_azi != self.azi) or (self.old_ele != self.ele)
        df = distance_factor(self.coordinates, cfg)
        if not xfade:
            out = interpolate_loops(spec2, self.db, idx, omg, df)
            y = self._inverse(out)[cfg.history_len :]
        else:
            oc = interpolation_calculations(self.old_ele, self.old_azi)
            oidx, oomg = oc.indices[0], oc.omegas[0]
            out_old = interpolate_loops(spec2, self.db, oidx, oomg, df)
            out_new = interpolate_loops(spec2.copy(), self.db, idx, omg, df)
            y_old = self._inverse(out_old)[cfg.history_len :]
            y_new = self._inverse(out_new)[cfg.history_len :]
            fn = (np.arange(cfg.frames_per_buffer, dtype=_F32) / _F32(cfg.frames_per_buffer - 1.0))[
                :, None
            ]
            y = (y_old * (_F32(1.0) - fn) + y_new * fn).astype(_F32)
        self.old_azi = self.azi
        self.old_ele = self.ele
        return y

    def fd_basic(self) -> np.ndarray:
        """Nearest-HRTF FD convolution, no distance/crossfade -> (frames, 2).
        (reference: Jefferson/src/CPUSoundSource.cpp:113-142)"""
        hrtf_idx = pick_hrtf(self.ele, self.azi)
        spec2 = self._forward_spectrum()
        out = (spec2 * self.db.spectra[hrtf_idx]).astype(_C64)
        return self._inverse(out)[self.config.history_len :]

    def td_convolve(self) -> np.ndarray:
        """Naive time-domain convolution of the current block -> (frames, 2).

        The reference's *intended* behavior: each output frame n convolves
        input[n-k] over the hrtf_len taps using the overlap-save history
        (its +2 pointer offset, CPUSoundSource.cpp:71, is not replicated).
        ``self.td_gain`` scales the output (clamped <= 1): 1.0 (the default)
        is the reference's CPU TD semantics (gain hardcoded to 1,
        CPUSoundSource.cpp:74); config.source_gain mirrors its GPU TD path
        (`value * gain`, kernels.cu:146) — PARITY.md's defect list.
        (reference: Jefferson/src/CPUSoundSource.cpp:66-112)
        """
        cfg = self.config
        hrtf_idx = pick_hrtf(self.ele, self.azi)
        h = self.db.hrirs[hrtf_idx, :, : cfg.hrtf_len]  # (2, taps)
        fpb = cfg.frames_per_buffer
        out = np.zeros((fpb, 2), dtype=_F32)
        xbuf = self.x
        start = cfg.history_len
        gain = _F32(min(self.td_gain, 1.0))
        for ch in range(2):
            acc = np.zeros(fpb, dtype=_F32)
            for k in range(cfg.hrtf_len):
                lo = start - k
                acc += xbuf[lo : lo + fpb] * h[ch, k]
            out[:, ch] = acc if gain == _F32(1.0) else acc * gain
        return out

    def process(self, ptype: ProcessType = ProcessType.CPU_FD_COMPLEX) -> np.ndarray:
        self.hrtf_idx = pick_hrtf(self.ele, self.azi)
        if ptype in (ProcessType.CPU_FD_COMPLEX, ProcessType.TPU_FD_COMPLEX):
            return self.fd_interpolate()
        if ptype in (ProcessType.CPU_FD_BASIC, ProcessType.TPU_FD_BASIC):
            return self.fd_basic()
        return self.td_convolve()


def render_oracle(
    signal: np.ndarray,
    db: HRTFDatabase,
    positions,
    config: EngineConfig = DEFAULT_CONFIG,
    ptype: ProcessType = ProcessType.CPU_FD_COMPLEX,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
    td_gain: float = 1.0,
) -> np.ndarray:
    """File-to-file oracle render, block by block like the reference's audio
    callback (reference: Jefferson/src/Audio.cu:119-157) -> (B*fpb, 2).

    ``positions``: per-block (azi_deg, ele_deg, r), applied as the
    reference's updateFromSpherical before each block; its length sets the
    number of blocks; the input wraps when exhausted.  ``initial_old``: the
    crossfade state before block 0; (0, 0) is the reference's SoundSource
    constructor, None seeds it with the first position so block 0 does not
    crossfade.  ``td_gain``: the TD path's output gain (see
    OracleSpatializer.td_convolve).
    """
    positions = list(positions)
    sp = OracleSpatializer(db, config)
    sp.td_gain = td_gain
    sp.buf = np.asarray(signal, dtype=_F32)
    if initial_old is None and positions:
        a0, e0, _ = positions[0]
        sp.old_azi = _F32(round_half_away(_F32(a0)))
        sp.old_ele = _F32(round_half_away(_F32(e0)))
    else:
        sp.old_azi, sp.old_ele = _F32(initial_old[0]), _F32(initial_old[1])
    out = np.zeros((len(positions) * config.frames_per_buffer, 2), dtype=_F32)
    fpb = config.frames_per_buffer
    for b, (azi, ele, r) in enumerate(positions):
        sp.update_from_spherical(ele=ele, azi=azi, r=r)
        sp.feed_from_buf()
        out[b * fpb : (b + 1) * fpb] = sp.process(ptype)
        sp.overlap_save()
    return out
