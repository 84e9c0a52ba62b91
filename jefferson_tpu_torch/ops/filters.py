"""Frequency-domain filter ops: distance factor, HRTF blend, complex
multiply, crossfade, on float32 planes and on complex64 (the ``fft``
backend).  Counterpart of ``jefferson_tpu/ops/filters.py``.

``distance_phase_split`` runs the port's host library for 1-D radii, as
the JAX module runs its native extension; ``_distance_phase_split_numpy``,
copied from the JAX module's NumPy branch, is its plain form and takes any
other shape.  ``tests/test_torch_ops.py`` and ``tests/test_torch_native.py``
pin both bit-for-bit to the original.  The device ops keep the JAX op order, which
is the contract the CUDA kernel's distance planes follow too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native

_MASK_LOW12 = np.int32(~0xFFF)


def distance_phase_split(fsvs: float, radii: np.ndarray, num_bins: int):
    """Host-side prep for the distance factor, float64-accurate on device.

    The distance cue's phase ramp is arg[k] = 2π·fsvs·r·k/N (reference:
    Jefferson/src/CPUSoundSource.cpp:46-47, kernels.cu:116-125).  For k up to
    512 a plain float32 product loses ~1e-4 rad of phase, so the per-block
    cycle step u = fsvs·r/N is split into a 12-bit head ``u_hi`` (whose
    product with any k < 4096 is exact in fp32) plus a tail ``u_lo``; the
    device reduces mod 1 after the exact head product, keeping phase error
    below ~1e-7 rad — matching the reference's double-precision cos/sin.

    Returns (u_hi, u_lo, inv_frac) float32 arrays shaped like ``radii``.
    ``radii`` are the *scaled* radii (|coords|/distance_scale) in float32.
    """
    r = np.asarray(radii, dtype=np.float32)
    if r.ndim == 1:
        return native.distance_phase_split(fsvs, r, num_bins)
    return _distance_phase_split_numpy(fsvs, r, num_bins)


def _distance_phase_split_numpy(fsvs: float, radii: np.ndarray, num_bins: int):
    """The plain form of ``distance_phase_split``, in NumPy, any shape."""
    r = np.asarray(radii, dtype=np.float32)
    fsvs32 = np.float32(fsvs)
    u = np.float64(fsvs32) * r.astype(np.float64) / np.float64(num_bins)
    u_hi = np.float32(u)
    u_hi = (u_hi.view(np.int32) & _MASK_LOW12).view(np.float32)
    u_lo = np.float32(u - u_hi)
    # frac = 1 + fsvs * r^2 in float32 like the reference
    frac = np.float32(1.0) + fsvs32 * r * r
    inv_frac = (np.float32(1.0) / frac).astype(np.float32)
    return u_hi, u_lo, inv_frac


def cmul(ar, ai, br, bi):
    """Elementwise complex multiply on explicit planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def distance_factors_split(u_hi, u_lo, inv_frac, num_bins: int):
    """(B,) phase-split params -> (B, num_bins) re/im distance planes.

    Op order is the JAX module's: the head product is exact, each mod-1
    reduction is a separate subtract, and nothing is fused."""
    k = torch.arange(num_bins, dtype=torch.float32, device=u_hi.device)
    head = u_hi[:, None] * k[None, :]
    head = head - torch.floor(head)
    cycles = head + u_lo[:, None] * k[None, :]
    cycles = cycles - torch.floor(cycles)
    arg = (2.0 * math.pi) * cycles
    return torch.cos(arg) * inv_frac[:, None], -torch.sin(arg) * inv_frac[:, None]


def distance_factors(u_hi, u_lo, inv_frac, num_bins: int) -> torch.Tensor:
    """(B,) phase-split params -> (B, num_bins) complex64 distance factors."""
    return torch.complex(*distance_factors_split(u_hi, u_lo, inv_frac, num_bins))


def blend_filters(spectra: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Gather and blend the 4 bracketing HRTF pairs of each block.

    spectra (num_hrtf, 2, bins) complex64; indices (B, 4) int; weights
    (B, 4) float32 -> (B, 2, bins) complex64.  The case logic of the
    reference's caseOne..caseFour chains (reference:
    Jefferson/src/GPUSoundSource.cu:118-317) is folded into the weights."""
    gathered = spectra[indices.long()]  # (B, 4, 2, bins)
    w = weights.to(torch.float32)
    return torch.einsum("bk,bkcf->bcf", torch.complex(w, torch.zeros_like(w)), gathered)


def blend_filters_split(spec_r: torch.Tensor, spec_i: torch.Tensor,
                        indices: torch.Tensor, weights: torch.Tensor):
    """Gather and blend on (num_hrtf, 2, bins) float32 planes -> (B, 2, bins) x2."""
    w = weights.to(torch.float32)
    idx = indices.long()
    gr = torch.einsum("bk,bkcf->bcf", w, spec_r[idx])
    gi = torch.einsum("bk,bkcf->bcf", w, spec_i[idx])
    return gr, gi


def blend_channel(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Weighted 4-row gather from one (num_hrtf, bins) channel plane ->
    (B, bins), one bracket after another in the JAX module's order."""
    w = weights.to(torch.float32)
    idx = indices.long()
    acc = w[:, 0:1] * table[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        acc = acc + w[:, j : j + 1] * table[idx[:, j]]
    return acc


def xfade_ramp(frames: int, device) -> torch.Tensor:
    """The crossfade ramp f[n] = n/(frames-1), float32, on ``device``.

    Divided on the host: torch's CUDA division by a Python scalar multiplies
    by the reciprocal, which can be one ulp off the true quotient that the
    JAX package and the CUDA step compute."""
    return (torch.arange(frames, dtype=torch.float32) / (frames - 1)).to(device)


def crossfade_tails(y_old, y_new, xfade):
    """Linear crossfade of the final block frames when the source moved.

    y_old/y_new: (B, 2, frames); xfade: (B,) bool.
    f[n] = n/(frames-1); out = old*(1-f) + new*f (reference:
    Jefferson/src/kernels.cu:132-137 — the new filter ramps in).
    """
    fn = xfade_ramp(y_new.shape[-1], y_new.device)
    mixed = y_old * (1.0 - fn) + y_new * fn
    return torch.where(xfade[:, None, None], mixed, y_new)
