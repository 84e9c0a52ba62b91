"""Bilinear HRTF interpolation setup: a copy of
``jefferson_tpu/trajectory/interpolation.py``, the NumPy form of
SoundSource::interpolationCalculations (reference:
Jefferson/src/SoundSource.cu:65-105) with the 4-way case dispatch of
cpuInterpolateLoops (reference: Jefferson/src/CPUSoundSource.cpp:255-273).

The reference's integer quirks are kept on purpose: C truncation toward
zero on every float->int cast (azi=354 at increment 6.43 gives theta0 =
theta1 = 353 and a negative omegaB), and weights that need not sum to 1.
``interpolation_calculations`` runs the port's host library, as the JAX
package's runs its native extension; ``_interpolation_calculations_numpy``
is its plain NumPy form.  ``tests/test_torch_hosts.py`` and
``tests/test_torch_native.py`` pin both to the original.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..hrtf.kemar import AZIMUTH_INC, ELEVATIONS, _pick_hrtf_numpy

_F32 = np.float32


def _trunc_i(x: np.ndarray) -> np.ndarray:
    """C float->int conversion: truncate toward zero."""
    return np.trunc(x).astype(np.int32)


@dataclasses.dataclass
class InterpCoeffs:
    """Per-position interpolation data (leading batch dims preserved)."""

    indices: np.ndarray   # (..., 4) int32 — HRTF filter indices
    weights: np.ndarray   # (..., 4) float32 — effective case weights
    omegas: np.ndarray    # (..., 6) float32 — raw omegaA..omegaF
    case: np.ndarray      # (...,) int8 — 1..4, which reference case fired


def _positions(ele, azi):
    """(ele, azi) as float32 arrays of one shape."""
    ele = np.atleast_1d(np.asarray(ele, dtype=_F32))
    azi = np.atleast_1d(np.asarray(azi, dtype=_F32))
    if ele.shape != azi.shape:
        ele, azi = np.broadcast_arrays(ele, azi)
    return ele, azi


def interpolation_calculations(ele, azi) -> InterpCoeffs:
    """The 4 filter indices and 6 omegas for (ele, azi) degrees, in float32
    (reference: SoundSource.cu:65-105), in the port's host library.  Scalars
    or arrays, broadcast."""
    ele, azi = _positions(ele, azi)
    shape = ele.shape
    idx, w, om, case = native.interp_plan(ele.ravel(), azi.ravel())
    return InterpCoeffs(
        indices=idx.reshape(shape + (4,)),
        weights=w.reshape(shape + (4,)),
        omegas=om.reshape(shape + (6,)),
        case=case.reshape(shape),
    )


def _interpolation_calculations_numpy(ele, azi) -> InterpCoeffs:
    """The plain form of ``interpolation_calculations``, in NumPy."""
    ele, azi = _positions(ele, azi)

    # phi[0] = int(ele)/10*10; phi[1] = int(ele+9)/10*10  (C integer division)
    def c_div10_mul10(v):
        return np.where(v < 0, -((-v) // 10 * 10), v // 10 * 10).astype(np.int32)

    phi0 = c_div10_mul10(_trunc_i(ele))
    phi1 = c_div10_mul10(_trunc_i(ele + _F32(9.0)))

    omega_e = ((ele - phi0.astype(_F32)) / _F32(10.0)).astype(_F32)
    omega_f = ((phi1.astype(_F32) - ele) / _F32(10.0)).astype(_F32)

    # deltaTheta by elevation row; a phi outside the table (undefined in the
    # reference) is clamped to the table's range
    def row_of(phi):
        r = (np.clip(phi, ELEVATIONS[0], ELEVATIONS[-1]) - ELEVATIONS[0]) // 10
        return r.astype(np.int32)

    dt1 = AZIMUTH_INC[row_of(phi0)].astype(_F32)
    dt2 = AZIMUTH_INC[row_of(phi1)].astype(_F32)

    # theta[j] = int( trunc(azi/dt)*dt ) with C truncation at every int cast
    def thetas(dt):
        t_lo = _trunc_i(_trunc_i(azi / dt).astype(_F32) * dt)
        t_hi = _trunc_i(_trunc_i((azi + dt - _F32(1.0)) / dt).astype(_F32) * dt)
        return t_lo, t_hi

    theta0, theta1 = thetas(dt1)
    theta2, theta3 = thetas(dt2)

    omega_a = ((azi - theta0.astype(_F32)) / dt1).astype(_F32)
    omega_b = ((theta1.astype(_F32) - azi) / dt1).astype(_F32)
    omega_c = ((azi - theta2.astype(_F32)) / dt2).astype(_F32)
    omega_d = ((theta3.astype(_F32) - azi) / dt2).astype(_F32)

    idx = np.stack(
        [
            _pick_hrtf_numpy(phi0.astype(_F32), theta0.astype(_F32)),
            _pick_hrtf_numpy(phi0.astype(_F32), theta1.astype(_F32)),
            _pick_hrtf_numpy(phi1.astype(_F32), theta2.astype(_F32)),
            _pick_hrtf_numpy(phi1.astype(_F32), theta3.astype(_F32)),
        ],
        axis=-1,
    ).astype(np.int32)

    omegas = np.stack([omega_a, omega_b, omega_c, omega_d, omega_e, omega_f], axis=-1)

    # case dispatch (reference: Jefferson/src/CPUSoundSource.cpp:258-272)
    i0, i1, i2, i3 = (idx[..., k] for k in range(4))
    case1 = (i0 == i1) & (i1 == i2) & (i2 == i3)
    case2 = ~case1 & (i0 == i2)
    case3 = ~case1 & ~case2 & (i0 == i1)
    case4 = ~(case1 | case2 | case3)
    case = (
        1 * case1.astype(np.int8)
        + 2 * case2.astype(np.int8)
        + 3 * case3.astype(np.int8)
        + 4 * case4.astype(np.int8)
    )

    zeros = np.zeros_like(omega_a)
    ones = np.ones_like(omega_a)
    # effective weights, float32 products chained as the reference chains
    # them (CPUSoundSource.cpp:174-175,202-203,239-242)
    w_c1 = np.stack([ones, zeros, zeros, zeros], axis=-1)
    w_c2 = np.stack([omega_b, omega_a, zeros, zeros], axis=-1)
    w_c3 = np.stack([omega_f, zeros, omega_e, zeros], axis=-1)
    w_c4 = np.stack(
        [
            (omega_f * omega_b).astype(_F32),
            (omega_f * omega_a).astype(_F32),
            (omega_e * omega_d).astype(_F32),
            (omega_e * omega_c).astype(_F32),
        ],
        axis=-1,
    )
    cs = case[..., None]
    weights = np.where(cs == 1, w_c1, np.where(cs == 2, w_c2, np.where(cs == 3, w_c3, w_c4)))

    return InterpCoeffs(
        indices=idx,
        weights=weights.astype(_F32),
        omegas=omegas.astype(_F32),
        case=case,
    )
