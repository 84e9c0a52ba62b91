"""SOFA (AES69) HRTF loader: modern datasets onto the engine's KEMAR grid.
A NumPy copy of ``jefferson_tpu/hrtf/sofa.py``, pinned to the original by
``tests/test_torch_hrtf_loaders.py``.

The reference only reads the 1994 MIT KEMAR WAV trees (reference:
Jefferson/src/hrtf_signals.cu:124-133); most HRTF sets published since
(HUTUBS, SADIE II, ARI, personalizations) ship as SOFA
`SimpleFreeFieldHRIR` files.  SOFA is netCDF-4, i.e. HDF5, read here with
h5py, imported only when a file is loaded.

Mapping: the engine's indexing (pick_hrtf, interpolation weights) is defined
on the fixed 710-point KEMAR grid, so the SOFA measurements are mapped onto
it, resampled to the engine rate and truncated/padded to hrtf_len.  This
keeps every parity-sensitive code path unchanged while opening the input
format.  Two mappings (round 5, ``mapping=``):

  * ``"nearest"`` — each grid direction takes the great-circle-nearest
    measurement's IR pair.  Exact for sets sampled on (or denser than) the
    grid, but SPARSE personalized sets alias: adjacent grid points snap to
    the same measurement, flattening the direction dependence
    diff/personalize.py exists to recover.
  * ``"interp3"`` — each grid direction blends its 3 nearest measurements
    with inverse-angular-distance weights, DELAY-ALIGNED first (each IR's
    onset shifted to the weighted mean onset before the weighted sum, then
    the blend carries that mean delay) so ITD interpolates instead of
    comb-filtering.  Exact-direction hits (< 0.05 deg) still copy the
    measurement verbatim, so dense/grid-sampled sets are unchanged.

  ``"auto"`` (default) picks interp3 when the set is sparse relative to
  the grid (worst grid-to-nearest-measurement angle > 5 deg), else nearest.
  tests/test_sofa.py quantifies the aliasing the sparse case removes.

Coordinate conventions: SOFA spherical azimuth is counterclockwise from
ahead (+90 = left); the engine's is clockwise from ahead (+90 = right,
reference: Jefferson/src/SoundSource.cu:28-33), so azimuth is negated.

AES69 conformance (round 5 review):

  * ``Data.Delay`` is applied — files that factor the broadband
    (interaural) delay out of ``Data.IR`` get it re-inserted per
    measurement/receiver (common part dropped as constant latency),
    so ITD survives the load instead of collapsing to the median plane.
  * Multi-distance sets keep the most-populated radius shell (with a
    warning) — the engine applies its own distance factor, and mixed
    shells would make nearest tie-break on file order and degenerate
    interp3's neighbor selection.
  * A common time-of-flight far beyond any in-band onset (> hrtf_len/4)
    is trimmed with a warning, so distant-measurement sets don't spend
    the whole filter window on leading silence; ordinary sets (KEMAR
    keeps its ITD in the taps) load bit-identically.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from .kemar import NUM_HRTF, HRTFDatabase, grid_position


def _unit(azi_deg: np.ndarray, ele_deg: np.ndarray) -> np.ndarray:
    """Direction unit vectors (engine convention) for angular distance."""
    a = np.deg2rad(np.asarray(azi_deg, np.float64))
    e = np.deg2rad(np.asarray(ele_deg, np.float64))
    return np.stack(
        [np.sin(a) * np.cos(e), np.sin(e), -np.cos(a) * np.cos(e)], axis=-1
    )


def _onset_delay(ir_pair: np.ndarray, frac: float = 0.2) -> int:
    """Onset sample of an IR pair: first index where the max-over-ears
    envelope reaches ``frac`` of its peak (0 for silent IRs)."""
    env = np.max(np.abs(ir_pair), axis=0)
    peak = env.max()
    if peak <= 0:
        return 0
    return int(np.argmax(env >= frac * peak))


def _shift(ir_pair: np.ndarray, k: int) -> np.ndarray:
    """Shift an IR pair by k samples (positive = later), zero-filled."""
    if k == 0:
        return ir_pair
    out = np.zeros_like(ir_pair)
    if k > 0:
        out[:, k:] = ir_pair[:, : ir_pair.shape[1] - k]
    else:
        out[:, :k] = ir_pair[:, -k:]
    return out


def _interp3_taps(ir: np.ndarray, cosang: np.ndarray,
                  num: int, n_taps: int, hrtf_len: int) -> np.ndarray:
    """Delay-aligned 3-nearest inverse-angular-distance blend per grid dir.

    ``cosang``: the (num, M) grid-to-measurement direction cosines load_sofa
    already computed for the auto decision.  Shifts run on the FULL-length
    IR rows and truncate to n_taps afterwards, so a neighbor shifted earlier
    than the weighted-mean onset pulls its real continuation into the window
    instead of zero-fill (n_taps only limits the OUTPUT window)."""
    k = min(3, cosang.shape[1])
    order = np.argsort(-cosang, axis=1)[:, :k]     # nearest first
    ang = np.arccos(np.take_along_axis(cosang, order, axis=1))  # (710, k)
    onsets = np.array([_onset_delay(ir[m]) for m in range(len(ir))])
    taps = np.zeros((num, 2, hrtf_len), np.float32)
    exact = np.deg2rad(0.05)
    for g in range(num):
        idx, a = order[g], ang[g]
        if a[0] < exact or k == 1:  # exact hit (or single measurement)
            taps[g, :, :n_taps] = ir[idx[0], :, :n_taps]
            continue
        # inverse-SQUARE angular weights: measured on the synthetic smooth
        # field (tests/test_sofa.py generator, 30-deg rings) — 0.72x nearest
        # RMS vs 0.78x for inverse-linear; the sharper falloff matters when
        # the 3 neighbors sit at unequal distances
        w = 1.0 / np.maximum(a, 1e-6) ** 2
        w /= w.sum()
        d = onsets[idx]
        d_mean = int(round(float(w @ d)))
        acc = np.zeros((2, n_taps), np.float64)
        for j in range(k):
            acc += w[j] * _shift(ir[idx[j]], d_mean - d[j])[:, :n_taps]
        taps[g, :, :n_taps] = acc.astype(np.float32)
    return taps


def load_sofa(
    path: str | Path, config: EngineConfig = DEFAULT_CONFIG,
    mapping: str = "auto",
) -> HRTFDatabase:
    """Load a SimpleFreeFieldHRIR SOFA file onto the KEMAR grid.

    ``mapping``: "nearest" | "interp3" | "auto" (see module docstring)."""
    import warnings

    import h5py

    if mapping not in ("nearest", "interp3", "auto"):
        # cheap argument validation before any file IO / resampling
        raise ValueError(f"unknown SOFA mapping {mapping!r}")
    path = Path(path)
    with h5py.File(path, "r") as f:
        if "Data.IR" not in f or "SourcePosition" not in f:
            raise ValueError(f"{path} is not a SimpleFreeFieldHRIR SOFA file")
        if "Data.SamplingRate" not in f:
            raise ValueError(f"{path} has no Data.SamplingRate")
        ir = np.asarray(f["Data.IR"])  # (M, R, N)
        sr = float(np.asarray(f["Data.SamplingRate"]).ravel()[0])
        pos = np.asarray(f["SourcePosition"])  # (M, >=2): azi, ele[, r]
        pos_type = f["SourcePosition"].attrs.get("Type", b"spherical")
        if isinstance(pos_type, bytes):
            pos_type = pos_type.decode()
        delay = np.asarray(f["Data.Delay"]) if "Data.Delay" in f else None
    if ir.ndim != 3 or ir.shape[1] != 2:
        raise ValueError(f"need 2-receiver HRIRs, got Data.IR shape {ir.shape}")
    m_meas = ir.shape[0]
    if m_meas == 0:
        raise ValueError(f"{path} contains no measurements (Data.IR is empty)")
    if pos.ndim != 2 or pos.shape[1] < 2:
        raise ValueError(
            f"SourcePosition must be (M, >=2) [azi, ele[, r]], got shape {pos.shape}"
        )
    if len(pos) != m_meas:
        raise ValueError(
            f"SourcePosition rows ({len(pos)}) != Data.IR measurements ({m_meas})"
        )
    if str(pos_type).lower() != "spherical":
        # 'cartesian' and 'spherical harmonics' rows are NOT (azi, ele)
        # angles; interpreting them as such would silently produce a
        # spatially-nonsense database
        raise ValueError(f"unsupported SourcePosition type {pos_type!r} (need 'spherical')")

    # AES69 Data.Delay ([I R] or [M R], samples at Data.SamplingRate): the
    # total response is Data.IR delayed per measurement/receiver.  Files
    # that factor the broadband (interaural) delay out of the IRs would
    # otherwise load with both ears' onsets coincident — near-zero ITD,
    # everything pulled toward the median plane.  The common part is
    # constant latency and is dropped; residuals round to integer samples
    # (sub-sample residue << the grid's own angular quantization).
    if delay is not None and np.any(delay != 0):
        d = np.asarray(delay, np.float64)
        if d.ndim != 2 or d.shape[1] != 2 or d.shape[0] not in (1, m_meas):
            raise ValueError(
                f"Data.Delay shape {d.shape} matches neither [I R]=(1, 2) "
                f"nor [M R]=({m_meas}, 2)"
            )
        di = np.rint(np.broadcast_to(d, (m_meas, 2)) - d.min()).astype(int)
        if di.max() > 0:
            n = ir.shape[-1]
            ext = np.zeros((m_meas, 2, n + int(di.max())), ir.dtype)
            for m in range(m_meas):
                for e in range(2):
                    ext[m, e, di[m, e] : di[m, e] + n] = ir[m, e]
            ir = ext

    # SOFA azimuth is CCW-positive (left); the engine's is CW-positive (right)
    src_azi = np.mod(-pos[:, 0], 360.0)
    src_ele = pos[:, 1]

    # Multi-distance sets (same directions measured at several radii): keep
    # the most-populated radius shell.  The engine applies its own distance
    # factor, and mixing shells makes 'nearest' tie-break on file order and
    # degenerates interp3's "3 nearest" to one direction at 3 radii (zero
    # angular distance between shells) — no spatial interpolation at all.
    if pos.shape[1] >= 3 and m_meas > 1:
        shells = np.round(pos[:, 2], 6)
        vals, counts = np.unique(shells, return_counts=True)
        if len(vals) > 1:
            keep_r = vals[np.argmax(counts)]
            keep = shells == keep_r
            warnings.warn(
                f"{path.name}: {len(vals)} measurement radii "
                f"{vals.tolist()}; keeping the most-populated shell "
                f"r={keep_r} ({int(keep.sum())}/{m_meas} measurements)"
            )
            ir, src_azi, src_ele = ir[keep], src_azi[keep], src_ele[keep]
            m_meas = ir.shape[0]

    if sr != config.sample_rate:
        from ..io.resample import resample

        m, r, n = ir.shape
        # one batched polyphase call (one filter design) over all rows
        ir = resample(
            ir.reshape(m * r, n).astype(np.float32), int(sr), config.sample_rate
        ).reshape(m, r, -1)

    # Common time-of-flight guard: sets measured at distance with the full
    # propagation delay left in-band (e.g. r=3 m ≈ 386 samples at 44.1 kHz)
    # would spend most of the hrtf_len window on leading silence.  Trim the
    # shared onset (constant latency, inaudible) only when it is far beyond
    # any real in-band ITD/onset (> hrtf_len/4), so ordinary sets — KEMAR
    # keeps its ITD in the taps — load bit-identically as before.
    tof = int(min(_onset_delay(ir[m]) for m in range(m_meas)))
    if tof > config.hrtf_len // 4:
        warnings.warn(
            f"{path.name}: common {tof}-sample time-of-flight consumed the "
            f"IR window; trimming it (constant latency, ITD preserved)"
        )
        ir = ir[:, :, tof:]

    n_taps = min(ir.shape[-1], config.hrtf_len)
    meas = _unit(src_azi, src_ele)  # (M, 3)

    grid_e, grid_a = zip(*(grid_position(i) for i in range(NUM_HRTF)))
    grid = _unit(np.asarray(grid_a, np.float64), np.asarray(grid_e, np.float64))

    cosang = np.clip(grid @ meas.T, -1.0, 1.0)
    if mapping == "auto":
        # sparse set: some grid direction sits > 5 deg from every
        # measurement — nearest-snap would alias (adjacent grid points
        # collapsing onto one measurement); dense sets keep exact snapping
        worst = float(np.rad2deg(np.arccos(cosang.max(axis=1).min())))
        mapping = "interp3" if worst > 5.0 else "nearest"

    if mapping == "interp3":
        taps = _interp3_taps(
            ir.astype(np.float64), cosang, NUM_HRTF, n_taps, config.hrtf_len
        )
    else:
        # nearest measurement per grid direction (great-circle = max dot)
        nearest = np.argmax(cosang, axis=1)  # (710,)
        taps = np.zeros((NUM_HRTF, 2, config.hrtf_len), np.float32)
        taps[:, :, :n_taps] = ir[nearest, :, :n_taps].astype(np.float32)
    return HRTFDatabase.from_hrirs(
        taps, config, source=f"sofa:{path.name}:{mapping}"
    )
