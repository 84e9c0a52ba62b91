"""MIT KEMAR grid, nearest-filter picking and the HRTF database: a copy of
the parts of ``jefferson_tpu/hrtf/kemar.py`` that the port uses.

The nonuniform grid (14 elevations -40..90 in steps of 10, per-elevation
azimuth increments) and the nearest-neighbour scan are the reference's,
its float accumulation included (reference:
Jefferson/src/hrtf_signals.cu:7-11,20-51,119-140).  ``pick_hrtf`` runs the
port's host library, as the JAX package's runs its native extension;
``_pick_hrtf_numpy`` is its plain NumPy form, and
``tests/test_torch_hosts.py`` and ``tests/test_torch_native.py`` pin both
to the original.  The KEMAR WAV tree loaders (full and compact layouts) and
``load_database`` are copies too, pinned bit for bit by
``tests/test_torch_hrtf_loaders.py``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import scipy.fft

from .. import native
from ..config import DEFAULT_CONFIG, EngineConfig
from ..io.wavio import read_wav

NUM_ELEV = 14
ELEVATIONS = np.array(
    [-40, -30, -20, -10, 0, 10, 20, 30, 40, 50, 60, 70, 80, 90], dtype=np.int32
)
# Per-elevation azimuth increments (reference: Jefferson/src/hrtf_signals.cu:9-10).
AZIMUTH_INC = np.array(
    [6.43, 6.00, 5.00, 5.00, 5.00, 5.00, 5.00, 6.00, 6.43, 8.00, 10.00, 15.00, 30.00, 361.0],
    dtype=np.float32,
)


def _enumerate_azimuths(elev_idx: int) -> np.ndarray:
    """One elevation row's azimuths, by the reference's float32 loop
    ``for (azi = 0; azi < 360; azi += azimuth_inc[i])``
    (reference: Jefferson/src/hrtf_signals.cu:121)."""
    inc = np.float32(AZIMUTH_INC[elev_idx])
    vals = []
    azi = np.float32(0.0)
    while azi < np.float32(360.0):
        vals.append(azi)
        azi = np.float32(azi + inc)
    return np.array(vals, dtype=np.float32)


AZIMUTH_GRIDS = [_enumerate_azimuths(i) for i in range(NUM_ELEV)]
AZIMUTH_COUNTS = np.array([len(g) for g in AZIMUTH_GRIDS], dtype=np.int32)
# hrtf index offset of each elevation row (reference: hrtf_signals.cu:139)
AZIMUTH_OFFSET = np.concatenate([[0], np.cumsum(AZIMUTH_COUNTS)]).astype(np.int32)
NUM_HRTF = int(AZIMUTH_OFFSET[-1])

assert NUM_HRTF == 710, f"KEMAR grid enumeration produced {NUM_HRTF} != 710"


def round_half_away(x):
    """C round(): halves round away from zero, computed exactly with floor
    and an exact fractional compare (floor(|x| + 0.5) misrounds float32
    inputs an ulp below a .5 boundary)."""
    x = np.asarray(x)
    a = np.abs(x)
    fl = np.floor(a)
    return np.sign(x) * np.where(a - fl >= 0.5, fl + 1, fl)


def _grid_args(obj_ele, obj_azi):
    """(ele, azi) float32 arrays broadcast together, and whether both were
    scalars."""
    ele = np.asarray(obj_ele, dtype=np.float32)
    azi = np.asarray(obj_azi, dtype=np.float32)
    scalar = ele.ndim == 0 and azi.ndim == 0
    ele, azi = np.broadcast_arrays(np.atleast_1d(ele), np.atleast_1d(azi))
    return ele, azi, scalar


def pick_hrtf(obj_ele, obj_azi) -> np.ndarray:
    """Nearest grid filter for (elevation, azimuth) in degrees: the
    reference's two linear scans (reference: hrtf_signals.cu:20-51), in the
    port's host library.  Elevation snaps to the nearest multiple of 10,
    then the closest row entry wins, the first minimum on ties.  Scalars or
    arrays."""
    ele, azi, scalar = _grid_args(obj_ele, obj_azi)
    # .ravel() copies the broadcast views contiguously
    idx = native.pick_hrtf(ele.ravel(), azi.ravel()).reshape(ele.shape)
    return idx[0] if scalar else idx


def _pick_hrtf_numpy(obj_ele, obj_azi) -> np.ndarray:
    """The plain form of ``pick_hrtf``: the same scans as NumPy argmins."""
    ele, azi, scalar = _grid_args(obj_ele, obj_azi)
    ele_snap = round_half_away(ele / 10).astype(np.float32) * np.float32(10.0)
    d_ele = np.abs(ele_snap[..., None] - ELEVATIONS.astype(np.float32))
    ele_idx = np.argmin(d_ele, axis=-1)

    azi_r = round_half_away(azi).astype(np.float32)
    inc = AZIMUTH_INC[ele_idx]
    n = AZIMUTH_COUNTS[ele_idx]
    i_grid = np.arange(int(AZIMUTH_COUNTS.max()), dtype=np.float32)
    # distance to i*inc for every candidate i; candidates past the row -> +inf
    d = np.abs(azi_r[..., None] - i_grid * inc[..., None]).astype(np.float32)
    d = np.where(i_grid < n[..., None], d, np.float32(np.inf))
    idx = (AZIMUTH_OFFSET[ele_idx] + np.argmin(d, axis=-1)).astype(np.int32)
    return idx[0] if scalar else idx


def grid_position(idx: int) -> tuple[int, float]:
    """Filter index -> (elevation_deg, azimuth_deg)."""
    row = int(np.searchsorted(AZIMUTH_OFFSET, idx, side="right") - 1)
    return int(ELEVATIONS[row]), float(AZIMUTH_GRIDS[row][idx - AZIMUTH_OFFSET[row]])


@dataclasses.dataclass
class HRTFDatabase:
    """The 710 HRIR pairs, zero-padded, and their half-spectra.

    ``hrirs``   (num_hrtf, 2, pad_len) float32, taps then zeros;
    ``spectra`` (num_hrtf, 2, num_bins) complex64, the unnormalized R2C FFT
    of ``hrirs``, the convention the reference uploads to its GPU
    (reference: Jefferson/src/hrtf_signals.cu:113-118).
    """

    hrirs: np.ndarray
    spectra: np.ndarray
    config: EngineConfig = DEFAULT_CONFIG
    source: str = "unknown"

    @property
    def num_hrtf(self) -> int:
        return self.hrirs.shape[0]

    @classmethod
    def from_hrirs(cls, taps: np.ndarray, config: EngineConfig = DEFAULT_CONFIG,
                   source: str = "unknown") -> "HRTFDatabase":
        """Build from raw taps (num_hrtf, 2, n_taps <= pad_len)."""
        n, ch, t = taps.shape
        if ch != 2 or t > config.pad_len:
            raise ValueError(f"bad HRIR shape {taps.shape} for pad_len={config.pad_len}")
        hrirs = np.zeros((n, 2, config.pad_len), dtype=np.float32)
        hrirs[:, :, :t] = taps.astype(np.float32)
        spectra = scipy.fft.rfft(hrirs, axis=-1).astype(np.complex64)
        return cls(hrirs=hrirs, spectra=spectra, config=config, source=source)


def _full_filename(root: Path, ele: int, azi_val: np.float32, ear: str) -> Path:
    # reference: Jefferson/src/hrtf_signals.cu:124,131 — "%s/elev%d/{L,R}%de%03da.wav"
    azi_name = int(round_half_away(float(azi_val)))
    return root / f"elev{ele}" / f"{ear}{ele}e{azi_name:03d}a.wav"


def load_full(root: str | Path, config: EngineConfig = DEFAULT_CONFIG) -> HRTFDatabase:
    """Load the full MIT KEMAR set: 710 x 2 per-ear mono WAVs."""
    root = Path(root)
    taps = None
    j = 0
    for i in range(NUM_ELEV):
        ele = int(ELEVATIONS[i])
        for azi in AZIMUTH_GRIDS[i]:
            for ch, ear in enumerate("LR"):
                x, sr = read_wav(_full_filename(root, ele, azi, ear))
                if sr != config.sample_rate or x.shape[1] != 1:
                    raise ValueError(f"bad HRIR file {_full_filename(root, ele, azi, ear)}")
                if taps is None:
                    taps = np.zeros((NUM_HRTF, 2, x.shape[0]), dtype=np.float32)
                if x.shape[0] != taps.shape[2]:
                    raise ValueError(
                        f"HRIR length mismatch: "
                        f"{_full_filename(root, ele, azi, ear)} has "
                        f"{x.shape[0]} taps, first file had {taps.shape[2]}"
                    )
                taps[j, ch, : x.shape[0]] = x[:, 0]
            j += 1
    return HRTFDatabase.from_hrirs(taps, config, source=f"full:{root}")


def load_compact(root: str | Path, config: EngineConfig = DEFAULT_CONFIG) -> HRTFDatabase:
    """Load the shipped compact KEMAR set (stereo right-hemisphere files).

    Grid azimuths > 180 deg use the mirrored file at (360 - azi) with L/R
    swapped, as the reference's legacy compact loader documents
    (reference: Jefferson/src/hrtf_signals.h:7-15).
    """
    root = Path(root)
    taps = None
    j = 0
    for i in range(NUM_ELEV):
        ele = int(ELEVATIONS[i])
        for azi in AZIMUTH_GRIDS[i]:
            a = float(azi)
            swap = a > 180.0
            a_file = 360.0 - a if swap else a
            azi_name = int(round_half_away(a_file))
            path = root / f"elev{ele}" / f"H{ele}e{azi_name:03d}a.wav"
            x, sr = read_wav(path)
            if sr != config.sample_rate or x.shape[1] != 2:
                raise ValueError(f"bad compact HRIR file {path}")
            if taps is None:
                taps = np.zeros((NUM_HRTF, 2, x.shape[0]), dtype=np.float32)
            if x.shape[0] != taps.shape[2]:
                raise ValueError(
                    f"HRIR length mismatch: {path} has {x.shape[0]} taps, "
                    f"first file had {taps.shape[2]}"
                )
            if swap:
                taps[j, 0, : x.shape[0]] = x[:, 1]
                taps[j, 1, : x.shape[0]] = x[:, 0]
            else:
                taps[j, 0, : x.shape[0]] = x[:, 0]
                taps[j, 1, : x.shape[0]] = x[:, 1]
            j += 1
    return HRTFDatabase.from_hrirs(taps, config, source=f"compact:{root}")


def load_database(root: str | Path, config: EngineConfig = DEFAULT_CONFIG) -> HRTFDatabase:
    """Detect the database format: a SOFA file, or a full or compact KEMAR
    WAV tree under ``root``.

    The SOFA grid mapping defaults to "auto" (nearest for dense sets,
    delay-aligned 3-nearest interpolation for sparse ones, hrtf/sofa.py);
    $JEFFERSON_SOFA_MAPPING=nearest|interp3|auto overrides it."""
    import os

    root = Path(root)
    if root.is_file() and root.suffix.lower() == ".sofa":
        from .sofa import load_sofa

        mapping = os.environ.get("JEFFERSON_SOFA_MAPPING", "auto")
        return load_sofa(root, config, mapping=mapping)
    if (root / "elev0" / "L0e000a.wav").exists():
        return load_full(root, config)
    if (root / "elev0" / "H0e000a.wav").exists():
        return load_compact(root, config)
    raise FileNotFoundError(
        f"no HRTF database (SOFA file or full/compact KEMAR tree) found at {root}"
    )


def synthetic_database(config: EngineConfig = DEFAULT_CONFIG, n_taps: int | None = None,
                       seed: int = 1234) -> HRTFDatabase:
    """Deterministic synthetic HRIR set with KEMAR-like structure: decaying
    bursts mixed by the direction vector, a fractional interaural delay and
    a level difference proportional to laterality, one global
    normalization, so neighbouring filters are correlated as in real data."""
    n_taps = config.hrtf_len if n_taps is None else n_taps
    if n_taps < 1:
        raise ValueError(f"n_taps must be >= 1, got {n_taps}")
    rng = np.random.default_rng(seed)
    t = np.arange(n_taps, dtype=np.float32)
    env = np.exp(-t / 40.0)
    bursts = rng.standard_normal((4, n_taps)).astype(np.float32) * env
    tap_grid = np.arange(n_taps, dtype=np.float64)

    taps = np.zeros((NUM_HRTF, 2, n_taps), dtype=np.float32)
    for idx in range(NUM_HRTF):
        ele, azi = grid_position(idx)
        a, e = np.deg2rad(azi), np.deg2rad(ele)
        # the reference's axes: +x right, +y up, -z ahead
        dx, dy, dz = np.sin(a) * np.cos(e), np.sin(e), -np.cos(a) * np.cos(e)
        mix = bursts[0] + 0.5 * dx * bursts[1] + 0.5 * dy * bursts[2] + 0.5 * dz * bursts[3]
        # channel 0 = left ear: delayed and attenuated when the source is right
        for ch, sign in ((0, +1.0), (1, -1.0)):
            delay = 7.5 * (1.0 + sign * dx)
            level = 1.0 - sign * 0.45 * dx
            taps[idx, ch] = level * np.interp(
                tap_grid - delay, tap_grid, mix.astype(np.float64), left=0.0, right=0.0
            ).astype(np.float32)
    taps *= 0.25 / max(np.max(np.abs(taps)), 1e-9)
    return HRTFDatabase.from_hrirs(taps, config, source=f"synthetic:{seed}")
