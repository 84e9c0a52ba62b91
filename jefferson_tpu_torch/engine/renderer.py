"""The single-source renderer, its chunk functions, and the planning helpers
it shares with the batched renderer.  Counterpart of
``jefferson_tpu/engine/renderer.py``.  The interpolating FD chunk (-t 0):

    sliding sub-block forward DFT -> (B, bins) planes
    -> extended HRTF blend (old set = previous block's new set) per ear
    -> x distance factor, x blended filters -> tail-only inverse DFT
    -> crossfade tails -> (B, fpb, 2)

In the ``matmul`` backend every tensor is a float32 (rows, bins) plane and
the filter table is the combined-plane layout [rL | iL | rR | iR]; the
``fft`` backend works on complex64 through ``torch.fft``.  The nearest-HRTF
FD chunk (-t 1) and the time-domain chunk (-t 2) are plain torch in both
packages (XLA ops there, no Pallas kernel).  The chunk functions keep the
JAX package's signatures; the fused ones run the CUDA steps of
``kernels/fused_step`` (their plain twins for CPU tensors).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import EngineConfig, ProcessType
from ..convert import spectra_from_numpy
from ..hrtf.kemar import HRTFDatabase
from ..kernels import fused_step
from ..kernels.fused_apply import fused_apply_xfade
from ..kernels.dma_blend import blend_rows
from ..kernels.fused_step import blend_cat
from ..ops import fft as fft_ops
from ..ops.filters import (
    blend_filters, cmul, crossfade_tails, distance_factors, distance_factors_split, xfade_ramp,
)
from ..parallel.mesh import block_range, check_mesh, gather_rows
from ..utils.profiling import span
from .plan import (
    RenderPlan, compact_filter_ids, compact_filter_ids_grouped, dedup_rows, fed_stream,
    make_plan,
)

_FD_COMPLEX = (ProcessType.TPU_FD_COMPLEX, ProcessType.CPU_FD_COMPLEX)
_FD_BASIC = (ProcessType.TPU_FD_BASIC, ProcessType.CPU_FD_BASIC)
BACKENDS = ("matmul", "fft")
# blocks a time-domain product takes at once: its strided window is copied
# into a (TD_ROWS, fpb, taps) operand, 64 MiB at the default geometry
TD_ROWS = 256


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
    *, config: EngineConfig, num_blocks: int, with_xfade: bool, backend: str = "matmul",
):
    """One chunk of one source's interpolating FD pipeline.
    Returns ((B, fpb, 2), new_hist).

    ``backend="matmul"``: float32 planes, the DFT as matmuls and the inverse
    truncated to the output tail; ``spectra`` is the (re, im) planes.
    ``backend="fft"``: complex64 through ``torch.fft``; ``spectra`` is the
    (num_hrtf, 2, bins) complex table."""
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * config.frames_per_buffer :]
    if backend == "fft":
        x_spec = fft_ops.rfft(_segments(full, num_blocks, config), config.pad_len)
        df = distance_factors(u_hi, u_lo, inv_frac, config.num_bins)
        g_new = blend_filters(spectra, idx_new, w_new) * df[:, None, :]
        prod_new = x_spec[:, None, :] * g_new
        if with_xfade:
            g_old = blend_filters(spectra, idx_old, w_old) * df[:, None, :]
            prod_old = x_spec[:, None, :] * g_old
            stacked = torch.cat([prod_old, prod_new], dim=1)
            y = fft_ops.irfft(stacked, config.pad_len)[..., config.history_len :]
            out = crossfade_tails(y[:, :2], y[:, 2:], xfade)
        else:
            out = fft_ops.irfft(prod_new, config.pad_len)[..., config.history_len :]
        return out.permute(0, 2, 1), new_hist
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


def _fd_complex_chunk_dedup(
    spectra, hist, fed, uniq_idx, uniq_w, inv, xfade, u_hi, u_lo, inv_frac,
    *, config: EngineConfig, num_blocks: int, with_xfade: bool,
):
    """Deduplicated variant of the unfused chunk: blend only the U unique
    (index, weight) rows and broadcast them with one row gather; the same
    per-row op order as the direct chunk.  ``inv`` maps extended row b ->
    unique id; with_xfade consumes B+1 rows (old[b] == new[b-1] by plan
    construction), otherwise B."""
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * config.frames_per_buffer :]
    xr, xi = _forward_split(full, num_blocks, config)
    g_cat = blend_cat(cat_table(spectra), uniq_idx, uniq_w)  # (U, 4*bins)
    g = split_planes(g_cat[inv.long()], config.num_bins)
    if with_xfade:
        g_old = tuple(a[:num_blocks] for a in g)
        g_new = tuple(a[1:] for a in g)
    else:
        g_old, g_new = None, g
    out = apply_filters_core(
        xr, xi, g_old, g_new, xfade, u_hi, u_lo, inv_frac,
        config=config, with_xfade=with_xfade,
    )
    return out, new_hist


def _fd_basic_chunk(spectra, hist, fed, nearest, *, config: EngineConfig, num_blocks: int,
                    backend: str = "matmul"):
    """Nearest-HRTF FD chunk (-t 1): no interpolation, distance or crossfade
    (reference: Jefferson/src/CPUSoundSource.cpp:113-142).  Returns
    ((B, fpb, 2), new_hist).  The matmul backend sums its tail by 128-bin
    blocks (``ops/fft.irfft_tail``), as the port's unfused -t 0 chain does."""
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * config.frames_per_buffer :]
    nearest = nearest.long()
    if backend == "fft":
        x_spec = fft_ops.rfft(_segments(full, num_blocks, config), config.pad_len)
        g = spectra[nearest]  # (B, 2, bins)
        y = fft_ops.irfft(x_spec[:, None, :] * g, config.pad_len)[..., config.history_len :]
        return y.permute(0, 2, 1), new_hist
    hr, hi = spectra
    xr, xi = _forward_split(full, num_blocks, config)
    qs = [cmul(xr, xi, hr[:, ch, :][nearest], hi[:, ch, :][nearest]) for ch in (0, 1)]
    y = fft_ops.irfft_tail(torch.stack([q[0] for q in qs]), torch.stack([q[1] for q in qs]),
                           config.pad_len, config.frames_per_buffer)  # (2, B, fpb)
    return y.permute(1, 2, 0), new_hist


def _td_chunk(hrirs, hist, fed, nearest, *, config: EngineConfig, num_blocks: int):
    """Time-domain chunk (-t 2): each block convolved with its nearest HRIR
    pair, the analogue of the reference's naive kernel (reference:
    Jefferson/src/kernels.cu:139-148).  Returns ((B, fpb, 2), new_hist).

    The output is scaled by the source gain clamped at 1, the reference's
    GPU TD semantics (``value * gain``, kernels.cu:146; the clamp
    GPUSoundSource.cu:418-419); its CPU TD path hardcodes gain 1
    (CPUSoundSource.cpp:74), and the oracle's ``td_gain`` matches either
    side (PARITY.md, "TD gain CPU/GPU divergence")."""
    fpb = config.frames_per_buffer
    taps = config.hrtf_len
    full = torch.cat([hist, fed])
    # each block's window: taps-1 samples of history, then its fpb samples
    start = config.history_len - (taps - 1)
    segs = full[start:].unfold(0, taps - 1 + fpb, fpb)[:num_blocks]  # (B, taps-1+fpb)
    h = hrirs[nearest.long()][:, :, :taps]  # (B, 2, taps)
    y = _td_direct(segs, h, fpb, taps)
    gain = min(config.source_gain, 1.0)
    if gain != 1.0:
        y = y * torch.tensor(gain, dtype=torch.float32, device=y.device)
    return y.permute(0, 2, 1), full[num_blocks * fpb :]


def _td_direct(segs: torch.Tensor, h: torch.Tensor, fpb: int, taps: int) -> torch.Tensor:
    """Per-block TD convolution as batched fp32 matmuls over sliding windows.

    segs (B, taps-1+fpb); h (B, 2, taps) -> (B, 2, fpb).  The JAX package's
    window is win[b, n, k] = segs[b, n+taps-1-k]; here it is the strided
    view u[b, n, j] = segs[b, n+j] against the reversed taps, so nothing is
    gathered, and ``TD_ROWS`` blocks at a time bound the copy a product
    makes of the view."""
    u = segs.unfold(1, taps, 1)                # (B, fpb, taps)
    hf = h.flip(-1).transpose(1, 2)            # (B, taps, 2)
    out = torch.empty((segs.shape[0], 2, fpb), dtype=segs.dtype, device=segs.device)
    for b0 in range(0, segs.shape[0], TD_ROWS):
        out[b0 : b0 + TD_ROWS] = torch.matmul(u[b0 : b0 + TD_ROWS],
                                              hf[b0 : b0 + TD_ROWS]).transpose(1, 2)
    return out


def dedup_distance(u_hi, u_lo, inv_frac, cap: int | None = None):
    """Compact-distance plan: (duh(8,), dul(8,), df(8,), sel(B,) int32, n)
    when the render's (u_hi, u_lo, inv_frac) triples take at most ``cap``
    unique values, else None.

    The triple depends only on r, so constant-radius workloads qualify (the
    |coordinates| round trip wobbles r by an ulp on scattered blocks, so
    "constant r" still yields 2-4 triples).  The step then takes each row's
    ramp from its exact triple: the same values as the per-row form."""
    cap = fused_step.MAX_DIST_UNIQ if cap is None else cap
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

    Needs tb | B, (seg | tb or tb | seg), and tb % 8 == 0.  The CUDA steps
    do not tile by it; the renderers use it to take the fused forms exactly
    where the JAX package's dispatch does, and the grouped one-hot form
    keeps its per-tile boundary rows."""
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


def _fd_complex_chunk_fused(
    spectra, hist, fed,
    idx_old,   # (B, 4) old-aligned rows; the NEW rows when not with_xfade
    w_old,
    idx_last,  # (1, 4) the chunk's final new row (unused when not with_xfade)
    w_last,
    xfade,     # (unused when not with_xfade)
    u_hi, u_lo, inv_frac, dsel=None,
    *, config: EngineConfig, num_blocks: int, n_dist: int | None = None,
    with_xfade: bool = True,
):
    """Gather-form fused chunk: blend the old-aligned rows (the new rows
    without the crossfade) and run the gather-form step, which derives the
    new rows as the next old row and the last new row."""
    fpb = config.frames_per_buffer
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * fpb :]
    cat = cat_table(spectra)
    g_rows = blend_rows(cat, idx_old, w_old)
    if with_xfade:
        g_last = blend_rows(cat, idx_last, w_last)
        xf = xfade.to(torch.float32)[:, None]
    else:
        g_last, xf = None, None
    y = _apply_maybe_full_fuse(
        full, u_hi, u_lo, inv_frac, g_rows, g_last, xf, config, num_blocks,
        dsel=dsel, n_dist=n_dist, with_xfade=with_xfade,
    )
    return y.reshape(num_blocks, 2, fpb).permute(0, 2, 1), new_hist


def _fd_complex_chunk_onehot(
    spectra, hist, fed,
    uniq_ids,   # (U_pad,) unique filter ids (plan.compact_filter_ids)
    ridx,       # (B, 4) OLD-aligned rows remapped into the table
    w_old,      # (B, 4)
    ridx_last,  # (1, 4)
    w_last,     # (1, 4)
    xfade, u_hi, u_lo, inv_frac, dsel=None,
    *, config: EngineConfig, num_blocks: int, n_dist: int | None = None,
):
    """One-hot compact-table chunk for one stream (row 3's step)."""
    fpb = config.frames_per_buffer
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * fpb :]
    table = cat_table(spectra)[uniq_ids.long()]
    y = fused_step.fused_step_stream_onehot_xfade(
        full, u_hi[:, None], u_lo[:, None], inv_frac[:, None],
        table, ridx, w_old, ridx_last, w_last, xfade.to(torch.float32)[:, None],
        pad_len=config.pad_len, bins=config.num_bins, fpb=fpb,
        dsel=None if dsel is None else dsel[:, None], n_dist=n_dist,
    )
    return y.reshape(num_blocks, 2, fpb).permute(0, 2, 1), new_hist


def _fd_complex_chunk_onehot_grouped(
    spectra, hist, fed,
    uniq_ids,  # (G*U_pad,) stacked per-group unique filter ids
    ridx,      # (B, 4) OLD-aligned rows remapped per group
    w_old,     # (B, 4)
    rbnd,      # (n_tiles, 4) per-tile boundary rows, per group
    wbnd,      # (n_tiles, 4)
    xfade, u_hi, u_lo, inv_frac, dsel=None,
    *, config: EngineConfig, num_blocks: int, tb: int, group_tiles: int, u_pad: int,
    n_dist: int | None = None,
):
    """Grouped one-hot chunk for wide movers (row 4's step): the chunk's
    tiles blend against per-group compact tables, one launch per chunk."""
    fpb = config.frames_per_buffer
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * fpb :]
    tables = cat_table(spectra)[uniq_ids.long()]  # (G*U_pad, 4*bins)
    y = fused_step.fused_step_stream_onehot_grouped_xfade(
        full, u_hi[:, None], u_lo[:, None], inv_frac[:, None],
        tables, ridx, w_old, rbnd, wbnd, xfade.to(torch.float32)[:, None],
        pad_len=config.pad_len, bins=config.num_bins, fpb=fpb, tb=tb,
        group_tiles=group_tiles, u_pad=u_pad,
        dsel=None if dsel is None else dsel[:, None], n_dist=n_dist,
    )
    return y.reshape(num_blocks, 2, fpb).permute(0, 2, 1), new_hist


def _apply_maybe_full_fuse(
    full, u_hi, u_lo, inv_frac, g_old, g_last, xf, config, num_blocks, dsel=None,
    n_dist: int | None = None, with_xfade: bool = True,
):
    """Run the gather-form fused step: forward DFT and distance in the
    kernel (row 5) when the history is a whole number of blocks, else the
    forward and distance in plain torch and the apply-only step (row 7)."""
    fpb = config.frames_per_buffer
    if config.history_len % fpb:
        if n_dist is not None:
            raise ValueError("compact distance needs the aligned geometry")
        xr, xi = _forward_split(full, num_blocks, config)
        xdr, xdi = cmul(xr, xi, *distance_factors_split(u_hi, u_lo, inv_frac, config.num_bins))
        icr, ici = fft_ops.on_device(fft_ops._idft_tail_matrices, config.pad_len, fpb,
                                     device=full.device)
        return fused_apply_xfade(xdr, xdi, g_old, g_last, xf, icr, ici, seg=num_blocks,
                                 bins=config.num_bins, fpb=fpb, with_xfade=with_xfade)
    return fused_step.fused_step_stream_xfade(
        full, u_hi[:, None], u_lo[:, None], inv_frac[:, None], g_old, g_last, xf,
        pad_len=config.pad_len, bins=config.num_bins, fpb=config.frames_per_buffer,
        dsel=None if dsel is None else dsel[:, None], n_dist=n_dist, with_xfade=with_xfade,
    )


def _apply_xfade_amortization(chunk_xfs: list[bool]) -> list[bool]:
    """The JAX package's policy for electing the no-crossfade form: only
    when at least two chunks would use it (a lone crossfade-free chunk
    rides the crossfade form; a render with no crossfade always does).  It
    paid for a second TPU compile; the port keeps it so it runs the same
    form per chunk."""
    if any(chunk_xfs) and 0 < chunk_xfs.count(False) < 2:
        return [True] * len(chunk_xfs)
    return chunk_xfs


def _sparse_bucket(max_ncf: int, rows: int) -> int | None:
    """Static cf-row bucket for the sparse-crossfade side-pass, or None
    when the crossfades are too dense for it (bucket > rows/8)."""
    if max_ncf <= 0:
        return None
    bucket = max(8, 1 << int(np.ceil(np.log2(max_ncf))))
    return bucket if bucket <= rows // 8 else None


def _pad_cf_indices(xfade_rows: np.ndarray, bucket: int) -> np.ndarray:
    """Crossfading-row ids padded to ``bucket`` by repeating the last real
    id (duplicates scatter identical values; an all-hold chunk pads with
    id 0, masked by its False xfade flag)."""
    cfi = np.flatnonzero(xfade_rows)
    if len(cfi) == 0:
        return np.zeros(bucket, np.int64)
    if len(cfi) < bucket:
        cfi = np.concatenate([cfi, np.repeat(cfi[-1:], bucket - len(cfi))])
    return cfi


def _sparse_xfade_fix(
    y, subs_all, cf_idx, g_old_cf, xfade, u_hi, u_lo, inv_frac,
    *, config: EngineConfig, nb_seg: int, xr_cf=None, xi_cf=None,
):
    """Fix up the few crossfading rows of a no-crossfade step's output.

    ``y`` (S*nb_seg, 2*fpb) holds the new-side tails of every row; the
    ``cf_idx`` rows (a small static bucket, padded by repeating a real id)
    are re-blended with an old-side tail computed here in plain torch: the
    forward DFT of just those rows in the sliding sub-block form (the
    association of ops/fft.rfft_sliding_split and the step's forward), the
    distance ramp, the old-filter apply and tail IDFT, and the crossfade,
    masked by each row's own xfade flag so padded ids rewrite their own
    values.  subs_all: (S*(nb_seg + q - 1), fpb) sub-block sample rows.
    Where the caller already holds every row's forward planes (the
    apply-only branch), it passes their ``cf_idx`` rows as ``xr_cf`` and
    ``xi_cf``, and they are not recomputed (the same values: one
    association)."""
    fpb = config.frames_per_buffer
    bins = config.num_bins
    n = config.pad_len
    q = n // fpb
    dev = y.device
    if xr_cf is not None:
        xr, xi = xr_cf, xi_cf
    else:
        s_ids = cf_idx // nb_seg
        base = cf_idx + s_ids * (q - 1)
        win = base[:, None] + torch.arange(q, device=dev)[None, :]    # (ncf, q)
        subs = subs_all[win]                                           # (ncf, q, fpb)
        cr, ci = fft_ops.on_device(fft_ops._subblock_dft_matrices, n, fpb, device=dev)
        ncf = cf_idx.shape[0]
        flat = subs.reshape(ncf * q, fpb)
        pr = (flat @ cr).reshape(ncf, q, bins)
        pi = (flat @ ci).reshape(ncf, q, bins)
        twr, twi = fft_ops.on_device(fft_ops._sliding_twiddles, n, fpb, device=dev)
        xr, xi = pr[:, 0], pi[:, 0]
        for m in range(1, q):
            a, b = twr[m][None, :], twi[m][None, :]
            xr = xr + (a * pr[:, m] - b * pi[:, m])
            xi = xi + (a * pi[:, m] + b * pr[:, m])
    dr, di = distance_factors_split(u_hi[cf_idx], u_lo[cf_idx], inv_frac[cf_idx], bins)
    xdr, xdi = cmul(xr, xi, dr, di)
    grl, gil, grr, gir = split_planes(g_old_cf, bins)
    qs = [cmul(xdr, xdi, grl, gil), cmul(xdr, xdi, grr, gir)]
    qr = torch.stack([qq[0] for qq in qs])                         # (2, ncf, bins)
    qi = torch.stack([qq[1] for qq in qs])
    y_old = fft_ops.irfft_tail_split(qr, qi, n, fpb)               # (2, ncf, fpb)
    fn = xfade_ramp(fpb, dev)
    y_new_cf = y[cf_idx]                                           # (ncf, 2*fpb)
    mask = xfade[cf_idx][:, None]
    cols = []
    for c in range(2):
        yn = y_new_cf[:, c * fpb : (c + 1) * fpb]
        mixed = y_old[c] * (1.0 - fn) + yn * fn
        cols.append(torch.where(mask, mixed, yn))
    y = y.clone()
    y[cf_idx] = torch.cat(cols, dim=1)
    return y


def _fd_complex_chunk_dedup_fused(
    spectra, hist, fed,
    uniq_idx,  # (U, 4)
    uniq_w,    # (U, 4)
    inv_old,   # (B,) unique-row id of each block's OLD filters (NEW when not with_xfade)
    inv_last,  # (1,) unique-row id of the chunk's final new row (unused when not with_xfade)
    xfade,     # (unused when not with_xfade, except sparse mode)
    u_hi, u_lo, inv_frac, dsel=None,
    cf_idx=None,  # (n_cf,) crossfading row ids (sparse)
    cf_old=None,  # (n_cf,) their OLD unique-row ids
    *, config: EngineConfig, num_blocks: int, n_dist: int | None = None,
    with_xfade: bool = True, n_cf: int | None = None,
):
    """Dedup + fused composition: blend only the unique rows, broadcast
    with one row gather, and run the gather-form step (row 5).

    ``with_xfade=False``: the chunk has no crossfading block; ``inv_old``
    carries the new-row ids and the step computes the new side only.
    ``n_cf`` (sparse crossfades): the chunk crossfades on at most n_cf rows;
    the no-crossfade step runs for all rows, then ``_sparse_xfade_fix``
    re-blends the ``cf_idx`` rows."""
    fpb = config.frames_per_buffer
    sparse = n_cf is not None
    assert not (sparse and with_xfade), "sparse mode implies the no-crossfade step"
    assert not (sparse and n_dist is not None), "the sparse side-pass keeps per-row ramps"
    full = torch.cat([hist, fed])
    new_hist = full[num_blocks * fpb :]
    cat = cat_table(spectra)
    g_u = blend_rows(cat, uniq_idx, uniq_w)
    g_rows = g_u[inv_old.long()]
    if with_xfade:
        g_last = g_u[inv_last.long()]
        xf = xfade.to(torch.float32)[:, None]
    else:
        g_last, xf = None, None
    y = _apply_maybe_full_fuse(
        full, u_hi, u_lo, inv_frac, g_rows, g_last, xf, config, num_blocks,
        dsel=dsel, n_dist=n_dist, with_xfade=with_xfade,
    )
    if sparse:
        # blend only the n_cf old rows the side-pass needs (the same values
        # as taking them from a full blend: per-row op order is unchanged)
        old = cf_old.long()
        g_old_cf = blend_rows(cat, uniq_idx[old], uniq_w[old])
        y = _sparse_xfade_fix(
            y, full.reshape(-1, fpb), cf_idx.long(), g_old_cf, xfade, u_hi, u_lo, inv_frac,
            config=config, nb_seg=num_blocks,
        )
    return y.reshape(num_blocks, 2, fpb).permute(0, 2, 1), new_hist


def cat_table(spectra) -> torch.Tensor:
    """Combined-plane filter table (num_hrtf, 4*bins) = [rL | iL | rR | iR]."""
    hr, hi = spectra
    return torch.cat([hr[:, 0, :], hi[:, 0, :], hr[:, 1, :], hi[:, 1, :]], dim=1)


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
    y = fft_ops.irfft_tail(qr, qi, config.pad_len, fpb)  # (2|4, B, fpb)
    if with_xfade:
        fn = xfade_ramp(fpb, y.device)
        mixed = y[:2] * (1.0 - fn) + y[2:] * fn
        out = torch.where(xfade[None, :, None], mixed, y[2:])
    else:
        out = y
    return out.permute(1, 2, 0)


def plan_onehot_chunking(plan: RenderPlan, b_total: int, cb: int, tb: int):
    """Render-wide one-hot geometry, as the JAX package plans it:
    (group_blocks, u_pad bucket | None).

    One U_pad bucket for every chunk of the render, and, when a chunk's
    unique-filter set exceeds MAX_ONEHOT_U, groups of ``group_blocks``
    blocks each with its own compact table (group == cb: the ungrouped
    form).  ``group_blocks`` is a multiple of the tile ``tb`` dividing
    ``cb``.  u_pad None when even tb-sized groups exceed the gate (the
    renderer then takes the gather form)."""

    def bucket(group: int) -> int:
        max_u = 1
        for start in range(0, b_total, group):
            stop = min(start + group, b_total)
            # each group's table also holds its boundary row (the next
            # group's first old row), which compact_filter_ids takes in
            # through idx_last
            bnd = plan.idx_old[stop : stop + 1] if stop < b_total else plan.idx_new[-1:]
            ids = np.unique(
                np.concatenate([plan.idx_old[start:stop].reshape(-1), bnd.reshape(-1)])
            )
            max_u = max(max_u, len(ids))
        return max(8, 1 << int(np.ceil(np.log2(max_u))))

    group = cb
    while True:
        u_pad = bucket(group)
        if u_pad <= fused_step.MAX_ONEHOT_U:
            return group, u_pad
        nxt = group // 2
        # groups stay whole multiples of the tile and divide the chunk
        if nxt < tb or nxt % tb or cb % nxt:
            return cb, None
        group = nxt


def check_card_geometry(config: EngineConfig, what: str = "fused=True",
                        remedy: str = "use fused=False or the CPU") -> None:
    """Raise, before any launch, unless the card's kernels take ``config``'s
    geometry (``fused_step.check_geometry``: refused only for a resource no
    form supplies, never for a fixed fpb or pad bound); every kernel's
    library is built for it at its first launch."""
    fused_step.check_geometry(config.frames_per_buffer, config.pad_len, what, remedy)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with its index; a CUDA device without a
    card raises, for nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: torch.cuda.is_available() is false; "
                               "pass device='cpu' to run the kernels' plain twins")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class ChunkFetch:
    """Each chunk's output back to the host, committed in chunk order.

    Synchronous (``pipelined=False``): ``put`` copies a chunk's output to
    the host and commits it at once.  Pipelined: ``put`` defers the chunk,
    one deep, and commits the chunk before it, so the host reads chunk i
    while chunk i+1, already launched, runs.  On a CUDA device chunk i's
    output goes device-to-host on a side stream, behind an event recorded
    after chunk i's launches, into one of two pinned host slots; the host
    reads a slot only after its copy's event completes, and a slot is
    refilled only after that read.  ``y.record_stream`` keeps the caching
    allocator from handing chunk i's output to chunk i+1 while the copy
    reads it.  On the CPU the same loop runs in the same order without a
    stream.  ``finish`` commits the last chunk.  An error raised at a
    deferred read propagates.
    """

    def __init__(self, device: torch.device, pipelined: bool):
        self.device = device
        self.pipelined = pipelined
        self._side = (torch.cuda.Stream(device) if pipelined and device.type == "cuda"
                      else None)
        self._slots: list[torch.Tensor] = []
        self._turn = 0
        self._pending = None

    def put(self, y: torch.Tensor, commit) -> None:
        """Hand over one chunk's output ``y``; ``commit(host_array)`` stores
        it (and copies it: a pinned slot is refilled two chunks later)."""
        if not self.pipelined:
            commit(y.cpu().numpy())
            return
        # a host tensor (a gloo collective's result) is read in place
        read = y.numpy if self._side is None or not y.is_cuda else self._copy(y)
        self.finish()
        self._pending = (commit, read)

    def _copy(self, y: torch.Tensor):
        """Start ``y``'s copy into the next pinned slot; the slot's reader."""
        # y's own strides: the copy is one memcpy, as .cpu() makes it
        if not self._slots or (self._slots[0].shape, self._slots[0].stride()) != (
                y.shape, y.stride()):
            self._slots = [torch.empty_strided(y.shape, y.stride(), dtype=y.dtype,
                                               pin_memory=True) for _ in range(2)]
        slot = self._slots[self._turn]
        self._turn ^= 1
        launched, copied = torch.cuda.Event(), torch.cuda.Event()
        launched.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            self._side.wait_event(launched)
            slot.copy_(y, non_blocking=True)
            copied.record(self._side)
        y.record_stream(self._side)

        def read():
            copied.synchronize()
            return slot.numpy()

        return read

    def finish(self) -> None:
        """Commit the deferred chunk, if any."""
        if self._pending is not None:
            commit, read = self._pending
            self._pending = None
            commit(read())


class Renderer:
    """Offline single-source renderer: one mono signal along per-block
    positions -> (B*fpb, 2) float32, chunk by chunk, for every process type
    (the CPU_* types render on the engine, as in the JAX package).

    ``config``: the engine geometry, ``db.config`` when None.  ``device``:
    where the chunks run, the card unless the caller asks for the CPU; CUDA
    runs the hand-written steps, the CPU their plain twins (a CUDA device
    without a card raises).  ``backend``: "matmul" (float32 planes) or
    "fft" (complex64 through ``torch.fft``; it turns ``dedup`` and
    ``fused`` off, as in the JAX package).  ``fused=True`` takes the JAX
    package's fused dispatch for -t 0 (dedup+fused, one-hot, grouped
    one-hot, gather-fused, with its no-crossfade and sparse-crossfade
    forms); ``fused=False`` its unfused arms (the dedup chunk and the plain
    chunk).  -t 1 and -t 2 run their plain torch chunks.  ``dedup`` and
    ``sparse_xfade`` are the JAX package's switches.  After each render,
    ``dispatch`` lists each chunk's (arm, with_xfade, sparse bucket).
    ``pipeline_fetch=True`` fetches each chunk's output one chunk late,
    after the next chunk is launched (``ChunkFetch``), bit-identical to the
    default synchronous fetch.

    A history that is not a whole number of blocks takes the apply-only
    step (row 7) where the JAX package does, on the card as on the CPU.
    ``fused=True`` on a CUDA device runs every geometry the JAX package
    runs (any fpb >= 2, any hrtf_len) and refuses at construction only one
    that needs a resource no kernel form supplies (``check_card_geometry``).

    ``mesh``: a 1-D ``DeviceMesh`` (``parallel.mesh.make_mesh(n,
    ("blk",))``) shards each chunk's blocks, SPMD: every rank of the mesh
    calls ``render`` with the whole input and computes its contiguous
    ``chunk / n`` blocks of every chunk, its overlap-save history read from
    the fed stream (``block_halo``: no halo moves between ranks), then one
    ``gather_rows`` a chunk gives every rank the whole chunk.  As in the
    JAX package ``chunk_blocks`` must divide over the mesh, a short
    render's chunk is padded up to a mesh multiple, and the mesh turns
    ``fused`` off (the unfused arms, the dedup chunk and the plain chunk,
    and -t 1 / -t 2).

    The JAX package's fallback ladder and its redo of a chunk whose
    deferred fetch failed are not carried over: a failed build or launch
    raises, and so does a deferred fetch.
    """

    def __init__(
        self,
        db: HRTFDatabase,
        config: EngineConfig | None = None,
        *,
        device="cuda",
        chunk_blocks: int = 2048,
        backend: str = "matmul",
        dedup: bool = True,
        fused: bool = True,
        sparse_xfade: bool = True,
        mesh=None,
        pipeline_fetch: bool = False,
    ):
        self.db = db
        self.config = config or db.config
        if chunk_blocks < 1:
            raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
        if backend not in BACKENDS:
            raise ValueError(f"unknown fft backend {backend!r}")
        if mesh is not None:
            if check_mesh(mesh).ndim != 1:
                raise ValueError("Renderer mesh must be 1-D (block axis)")
            if chunk_blocks % mesh.size():
                raise ValueError(f"chunk_blocks ({chunk_blocks}) must divide evenly over the "
                                 f"{mesh.size()}-device mesh")
            # the block shards run the unfused chunks, as in the JAX package
            fused = False
        self.mesh = mesh
        self.backend = backend
        self.dedup = dedup and backend != "fft"
        self.fused = fused and backend != "fft"
        if self.fused and torch.device(device).type == "cuda":
            check_card_geometry(self.config)
        self.device = resolve_device(device)
        self.pipeline_fetch = pipeline_fetch
        self.chunk_blocks = chunk_blocks
        self.sparse_xfade = sparse_xfade
        self.dispatch: list[tuple[str, bool, int | None]] = []
        if backend == "fft":
            self._spectra = torch.from_numpy(np.asarray(db.spectra, np.complex64)).to(self.device)
        else:
            self._spectra = spectra_from_numpy(db.spectra, self.device)
        self._hrirs = torch.from_numpy(np.asarray(db.hrirs, np.float32)).to(self.device)

    def render(
        self,
        signal: np.ndarray,
        positions: Sequence | np.ndarray,
        ptype: ProcessType = ProcessType.TPU_FD_COMPLEX,
        initial_old: tuple[float, float] | None = (0.0, 0.0),
    ) -> np.ndarray:
        """Render mono ``signal`` along per-block ``positions`` -> (B*fpb, 2).
        The plan and the chunks are named spans in a ``utils.profiling.trace``."""
        with span("renderer.plan"):
            plan = make_plan(np.asarray(positions), self.config, initial_old)
        with span("renderer.chunks"):
            return self.render_plan(signal, plan, ptype)

    def render_plan(
        self, signal: np.ndarray, plan: RenderPlan,
        ptype: ProcessType = ProcessType.TPU_FD_COMPLEX,
    ) -> np.ndarray:
        """Render a prepared plan chunk by chunk.

        FD_COMPLEX dispatch, in the JAX package's order: dedup+fused when
        positions repeat, one-hot (grouped when wide) for movers, then
        gather-fused, then the unfused chunk.  FD_BASIC and TD take their
        one chunk each."""
        ptype = ProcessType(ptype)
        interp = ptype in _FD_COMPLEX
        cfg = self.config
        if interp and plan.num_blocks > 1 and not (
            np.array_equal(plan.idx_old[1:], plan.idx_new[:-1])
            and np.array_equal(plan.w_old[1:], plan.w_new[:-1])
        ):
            # the steps derive the old filter set from the previous block's
            # new set; make_plan guarantees this
            raise ValueError(
                "RenderPlan old-position arrays must equal the previous "
                "block's new arrays (build plans with make_plan)"
            )
        fpb = cfg.frames_per_buffer
        b_total = plan.num_blocks
        cb = min(self.chunk_blocks, b_total) if b_total else self.chunk_blocks
        if self.mesh is not None and cb % self.mesh.size():
            # a short render keeps its chunk a mesh multiple (never above
            # chunk_blocks, itself a multiple); the padding is trimmed
            cb += self.mesh.size() - cb % self.mesh.size()
        aligned = cfg.history_len % fpb == 0
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        off, nb_run = 0, cb  # this rank's blocks [off, off + nb_run) of every chunk
        if self.mesh is not None:
            off, stop_ = block_range(self.mesh, cb)
            nb_run = stop_ - off
        # the history, every fed sample and the final chunk's zero padding:
        # each chunk's history (its halo) and fed blocks are read from it
        stream = np.concatenate([np.zeros(cfg.history_len, np.float32),
                                 fed_stream(signal, b_total, cfg),
                                 np.zeros((-b_total % cb) * fpb, np.float32)])
        out = np.empty((b_total * fpb, 2), dtype=np.float32)
        with_xfade = bool(plan.xfade.any())
        self.dispatch = []

        def pad(a, nb):
            """A chunk's per-block rows, the final chunk padded with its last
            row; this rank's blocks of them."""
            if nb < cb:
                a = np.concatenate([a, np.repeat(a[-1:], cb - nb, axis=0)])
            return put(a[off : off + nb_run])

        # compact distance for the one-hot arms only; the gather arms keep
        # per-row ramps, as the JAX dispatch does
        dist = dedup_distance(plan.u_hi, plan.u_lo, plan.inv_frac)
        nd = None if dist is None else dist[4]

        def row_dist(sl, nb):
            return (pad(plan.u_hi[sl], nb), pad(plan.u_lo[sl], nb), pad(plan.inv_frac[sl], nb))

        # dedup: the unique blend rows of each chunk's extended (cb+1) rows,
        # one bucket per render; declined when positions do not repeat
        dedup_chunks = None
        if self.dedup and b_total and interp:
            dedup_chunks, max_u = [], 1
            for start in range(0, b_total, cb):
                sl = slice(start, min(start + cb, b_total))
                ext_idx = np.concatenate([plan.idx_old[start : start + 1], plan.idx_new[sl]])
                ext_w = np.concatenate([plan.w_old[start : start + 1], plan.w_new[sl]])
                if ext_idx.shape[0] < cb + 1:  # final partial chunk
                    reps = cb + 1 - ext_idx.shape[0]
                    ext_idx = np.concatenate([ext_idx, np.repeat(ext_idx[-1:], reps, axis=0)])
                    ext_w = np.concatenate([ext_w, np.repeat(ext_w[-1:], reps, axis=0)])
                uniq_idx, uniq_w, inv = dedup_rows(ext_idx, ext_w)
                max_u = max(max_u, uniq_idx.shape[0])
                dedup_chunks.append((uniq_idx, uniq_w, inv))
            u_pad = max(8, 1 << int(np.ceil(np.log2(max_u))))
            if u_pad * 2 > cb:
                dedup_chunks = None

        # sparse crossfades: one no-crossfade step + side-pass for every
        # chunk when every chunk's crossfade count fits a small bucket
        sparse_ncf = None
        if dedup_chunks is not None and self.fused and self.sparse_xfade and aligned and b_total:
            max_ncf = max(int(plan.xfade[start : min(start + cb, b_total)].sum())
                          for start in range(0, b_total, cb))
            sparse_ncf = _sparse_bucket(max_ncf, cb)

        chunk_xfs = _apply_xfade_amortization([
            bool(plan.xfade[start : min(start + cb, b_total)].any())
            for start in range(0, b_total, cb)
        ])

        # one-hot geometry: one table bucket per render, per-group tables
        # for wide movers
        tb = pick_fused_tile(cb, cb) if self.fused else None
        onehot_u_pad, onehot_group = None, None
        if tb is not None and with_xfade and dedup_chunks is None and b_total and aligned \
                and interp:
            onehot_group, onehot_u_pad = plan_onehot_chunking(plan, b_total, cb, tb)

        kw = dict(config=cfg, num_blocks=nb_run)
        fetch = ChunkFetch(self.device, self.pipeline_fetch)
        for start in range(0, b_total, cb):
            stop = min(start + cb, b_total)
            nb = stop - start
            sl = slice(start, stop)
            first = start + off
            hist = put(block_halo(stream, first, cfg))
            fed = put(stream[cfg.history_len + first * fpb :
                             cfg.history_len + (first + nb_run) * fpb])
            cxf = chunk_xfs[start // cb]
            last_i = plan.idx_new[stop - 1 : stop]
            last_w = plan.w_new[stop - 1 : stop]

            def with_last(a, nxt):
                """Old-aligned rows; a padded final chunk continues with the
                final real block's NEW row, which the step reads as block
                nb-1's new filter."""
                return a if nb == cb else np.concatenate([a, np.repeat(nxt, cb - nb, axis=0)])

            if ptype in _FD_BASIC:
                y, _ = _fd_basic_chunk(self._spectra, hist, fed, pad(plan.nearest[sl], nb),
                                            **kw, backend=self.backend)
                arm = ("fd_basic", False, None)
            elif not interp:
                y, _ = _td_chunk(self._hrirs, hist, fed, pad(plan.nearest[sl], nb), **kw)
                arm = ("td", False, None)
            elif onehot_u_pad is not None:
                io_np = with_last(plan.idx_old[sl], last_i)
                wo_np = with_last(plan.w_old[sl], last_w)
                if dist is None:
                    tail = (pad(plan.xfade[sl], nb), *row_dist(sl, nb), None)
                else:  # the (8,) triples and each block's selector
                    tail = (pad(plan.xfade[sl], nb), *(put(a) for a in dist[:3]),
                            pad(dist[3][sl], nb))
                if onehot_group < cb:
                    uniq_ids, ridx, rbnd = compact_filter_ids_grouped(
                        io_np, last_i, onehot_group, tb, onehot_u_pad)
                    wbnd = np.concatenate([wo_np[tb::tb], last_w])
                    y, _ = _fd_complex_chunk_onehot_grouped(
                        self._spectra, hist, fed, put(uniq_ids), put(ridx), put(wo_np),
                        put(rbnd), put(wbnd), *tail, **kw, tb=tb,
                        group_tiles=onehot_group // tb, u_pad=onehot_u_pad, n_dist=nd)
                    arm = ("onehot_grouped", True, None)
                else:
                    uniq_ids, ridx, ridx_last, _ = compact_filter_ids(
                        io_np, last_i, u_pad=onehot_u_pad)
                    y, _ = _fd_complex_chunk_onehot(
                        self._spectra, hist, fed, put(uniq_ids), put(ridx), put(wo_np),
                        put(ridx_last), put(last_w), *tail, **kw, n_dist=nd)
                    arm = ("onehot", True, None)
            elif dedup_chunks is None and tb is not None:
                rows_i = plan.idx_old[sl] if cxf else plan.idx_new[sl]
                rows_w = plan.w_old[sl] if cxf else plan.w_new[sl]
                y, _ = _fd_complex_chunk_fused(
                    self._spectra, hist, fed, put(with_last(rows_i, last_i)),
                    put(with_last(rows_w, last_w)), put(last_i), put(last_w), pad(plan.xfade[sl], nb), *row_dist(sl, nb),
                    **kw, with_xfade=cxf)
                arm = ("gather_fused", cxf, None)
            elif dedup_chunks is not None:
                uniq_idx, uniq_w, inv = dedup_chunks[start // cb]
                if uniq_idx.shape[0] < u_pad:  # pad to the render's bucket
                    reps = u_pad - uniq_idx.shape[0]
                    uniq_idx = np.concatenate([uniq_idx, np.repeat(uniq_idx[-1:], reps, axis=0)])
                    uniq_w = np.concatenate([uniq_w, np.repeat(uniq_w[-1:], reps, axis=0)])
                if tb is not None:
                    dxf = cxf and sparse_ncf is None
                    cf = {}
                    if sparse_ncf is not None:
                        cfi = _pad_cf_indices(plan.xfade[sl], sparse_ncf)
                        cf = dict(cf_idx=put(cfi), cf_old=put(inv[:cb][cfi]))
                    y, _ = _fd_complex_chunk_dedup_fused(
                        self._spectra, hist, fed, put(uniq_idx), put(uniq_w),
                        # old-aligned rows for the crossfade form, the NEW
                        # rows for the no-crossfade one
                        put(inv[:cb] if dxf else inv[1 : cb + 1]), put(inv[cb : cb + 1]),
                        pad(plan.xfade[sl], nb), *row_dist(sl, nb), **cf, **kw,
                        with_xfade=dxf, n_cf=sparse_ncf)
                    arm = ("dedup_fused", dxf, sparse_ncf)
                else:
                    # extended rows [off, off + nb_run] with the crossfade,
                    # the new rows of this rank's blocks without
                    rows = inv[off : off + nb_run + 1] if cxf else inv[1 + off : 1 + off + nb_run]
                    y, _ = _fd_complex_chunk_dedup(
                        self._spectra, hist, fed, put(uniq_idx), put(uniq_w), put(rows),
                        pad(plan.xfade[sl], nb), *row_dist(sl, nb), **kw, with_xfade=cxf)
                    arm = ("dedup", cxf, None)
            else:
                y, _ = _fd_complex_chunk(
                    self._spectra, hist, fed,
                    *(pad(getattr(plan, a)[sl], nb)
                      for a in ("idx_new", "w_new", "idx_old", "w_old", "xfade")),
                    *row_dist(sl, nb), **kw, with_xfade=cxf, backend=self.backend)
                arm = ("plain", cxf, None)
            def commit(host, start=start, stop=stop):
                out[start * fpb : stop * fpb] = host[: (stop - start) * fpb]

            self.dispatch.append(arm)
            if self.mesh is not None:
                y = gather_rows(y, self.mesh)
            fetch.put(y.reshape(cb * fpb, 2), commit)
        fetch.finish()
        return out


def block_halo(stream: np.ndarray, block: int, config: EngineConfig) -> np.ndarray:
    """The overlap-save history before ``block`` of a render: the
    ``history_len`` samples of ``stream`` (zeros(history_len) followed by
    the fed samples) that a chunk starting at ``block`` reads, equal to the
    history the previous chunk's step carries out."""
    start = block * config.frames_per_buffer
    return stream[start : start + config.history_len]
