"""The unfused interpolating FD chain and the planning helpers it shares
with the batched renderer.  Counterpart of a subset of
``jefferson_tpu/engine/renderer.py`` (matmul backend only):

    sliding sub-block forward DFT -> (B, bins) planes
    -> extended HRTF blend (old set = previous block's new set) per ear
    -> x distance factor, x blended filters -> tail-only inverse DFT
    -> crossfade tails -> (B, fpb, 2)

Every tensor is a float32 (rows, bins) plane; the filter table is the
combined-plane layout [rL | iL | rR | iR].
"""

from __future__ import annotations

import numpy as np
import torch

from jefferson_tpu.config import EngineConfig

from ..ops import fft as fft_ops
from ..ops.filters import cmul, distance_factors_split, xfade_ramp


def _segments(full: torch.Tensor, num_blocks: int, config: EngineConfig) -> torch.Tensor:
    """(hist + B*fpb,) sample stream -> (B, pad_len) overlap-save windows."""
    return full.unfold(0, config.pad_len, config.frames_per_buffer)[:num_blocks]


def _forward_split(full: torch.Tensor, num_blocks: int, config: EngineConfig):
    """Forward DFT planes of all overlap-save windows: the sliding sub-block
    decomposition when the history is a whole number of blocks (the default
    geometry), explicit windows otherwise."""
    if config.history_len % config.frames_per_buffer == 0:
        return fft_ops.rfft_sliding_split(
            full, num_blocks, config.frames_per_buffer, config.pad_len
        )
    return fft_ops.rfft_split(_segments(full, num_blocks, config), config.pad_len)


def _fd_complex_chunk(
    spectra, hist, fed, idx_new, w_new, idx_old, w_old, xfade, u_hi, u_lo, inv_frac,
    *, config: EngineConfig, num_blocks: int, with_xfade: bool,
):
    """One chunk of one source's interpolating FD pipeline (matmul backend).
    Returns ((B, fpb, 2), new_hist)."""
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * config.frames_per_buffer :]
    xr, xi = _forward_split(full, num_blocks, config)
    if with_xfade:
        # old filters of block b are new filters of block b-1 by plan
        # construction, so one extended blend of B+1 rows serves both sets
        idx_ext = torch.cat([idx_old[:1], idx_new], dim=0)
        w_ext = torch.cat([w_old[:1], w_new], dim=0)
        g = blend_channels(spectra, idx_ext, w_ext)
        g_old = tuple(a[:num_blocks] for a in g)
        g_new = tuple(a[1:] for a in g)
    else:
        g_new = blend_channels(spectra, idx_new, w_new)
        g_old = None
    out = apply_filters_core(
        xr, xi, g_old, g_new, xfade, u_hi, u_lo, inv_frac,
        config=config, with_xfade=with_xfade,
    )
    return out, new_hist


def dedup_distance(u_hi, u_lo, inv_frac, cap: int | None = None):
    """Compact-distance plan: (duh(8,), dul(8,), df(8,), sel(B,) int32, n)
    when the render's (u_hi, u_lo, inv_frac) triples take at most ``cap``
    unique values, else None.

    The triple depends only on r, so constant-radius workloads qualify (the
    |coordinates| round trip wobbles r by an ulp on scattered blocks, so
    "constant r" still yields 2-4 triples).  The step then takes each row's
    ramp from its exact triple: the same values as the per-row form."""
    from ..kernels.fused_step import MAX_DIST_UNIQ

    cap = MAX_DIST_UNIQ if cap is None else cap
    # the step's unique-triple operand has 8 rows
    assert cap <= 8, f"compact-distance cap {cap} exceeds the kernel's 8 rows"
    if len(u_hi) == 0:
        return None
    trip = np.stack([u_hi, u_lo, inv_frac], axis=1)
    uniq, inv = np.unique(trip, axis=0, return_inverse=True)
    n = len(uniq)
    if n > cap:
        return None
    if n < 8:  # pad the triple rows to the fixed (8, 1) operand
        uniq = np.concatenate([uniq, np.repeat(uniq[-1:], 8 - n, axis=0)])
    return (
        uniq[:, 0].astype(np.float32),
        uniq[:, 1].astype(np.float32),
        uniq[:, 2].astype(np.float32),
        inv.astype(np.int32),
        n,
    )


def pick_fused_tile(b: int, seg: int, max_tb: int = 256) -> int | None:
    """Largest fused-step tile <= max_tb compatible with (B, seg), or None.

    Needs tb | B, (seg | tb or tb | seg), and tb % 8 == 0.  The CUDA step
    does not tile by it; the batched renderer uses it to leave the one-hot
    form exactly where the JAX package's dispatch does."""
    if b <= 0 or seg <= 0 or b % seg:
        return None
    if seg >= max_tb:
        for t in (256, 128, 64, 32, 16, 8):
            if t <= max_tb and seg % t == 0:
                return t
        return None
    n_seg = b // seg
    for m in range(max_tb // seg, 0, -1):
        t = m * seg
        if n_seg % m == 0 and t % 8 == 0:
            return t
    return None


def cat_table(spectra) -> torch.Tensor:
    """Combined-plane filter table (num_hrtf, 4*bins) = [rL | iL | rR | iR]."""
    hr, hi = spectra
    return torch.cat([hr[:, 0, :], hi[:, 0, :], hr[:, 1, :], hi[:, 1, :]], dim=1)


def blend_cat(table_cat: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted 4-row gather on the combined table -> (rows, 4*bins), summed
    in bracket order (the CUDA step blends in the same order)."""
    w = weights.to(torch.float32)
    idx = indices.long()
    acc = w[:, 0:1] * table_cat[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        acc = acc + w[:, j : j + 1] * table_cat[idx[:, j]]
    return acc


def split_planes(cat: torch.Tensor, bins: int):
    """(rows, 4*bins) combined blend -> (grL, giL, grR, giR) column views."""
    return tuple(cat[..., k * bins : (k + 1) * bins] for k in range(4))


def blend_channels(spectra, indices: torch.Tensor, weights: torch.Tensor):
    """Per-ear weighted filter blends: (rows, 4) indices/weights ->
    (grL, giL, grR, giR), each (rows, bins)."""
    hr, _ = spectra
    return split_planes(blend_cat(cat_table(spectra), indices, weights), hr.shape[-1])


def apply_filters_core(
    xr, xi, g_old, g_new, xfade, u_hi, u_lo, inv_frac,
    *, config: EngineConfig, with_xfade: bool,
):
    """Filter application on forward planes -> (B, fpb, 2) stereo tails.

    The distance factor is folded into the input spectrum once ((X·D)·G),
    shared by all filter sets, as in the JAX package."""
    fpb = config.frames_per_buffer
    dr, di = distance_factors_split(u_hi, u_lo, inv_frac, config.num_bins)
    xdr, xdi = cmul(xr, xi, dr, di)

    def q_set(g):
        grl, gil, grr, gir = g
        return [cmul(xdr, xdi, grl, gil), cmul(xdr, xdi, grr, gir)]

    qs = (q_set(g_old) if with_xfade else []) + q_set(g_new)
    qr = torch.stack([q[0] for q in qs])  # (2 or 4, B, bins)
    qi = torch.stack([q[1] for q in qs])
    y = fft_ops.irfft_tail_split(qr, qi, config.pad_len, fpb)  # (2|4, B, fpb)
    if with_xfade:
        fn = xfade_ramp(fpb, y.device)
        mixed = y[:2] * (1.0 - fn) + y[2:] * fn
        out = torch.where(xfade[None, :, None], mixed, y[2:])
    else:
        out = y
    return out.permute(1, 2, 0)
