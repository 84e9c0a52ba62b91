"""The batched fused render step: CUDA kernel, its plain-PyTorch twin, and
the wrapper that picks one by where the operands lie.

Replaces the TPU kernel ``_onehot_kernel`` (jefferson_tpu/pallas/
fused_step.py:347) as called by ``fused_step_onehot_xfade`` (:721) with one
shared compact table (``group_tiles=None``).  Per row r = s*nb + b it
computes the sliding sub-block forward DFT, the distance planes (per row,
or selected from <= 8 unique triples), the 4-bracket filter blend of the
old row, the new row as the next old row of the same source (the last
block of a source takes ``ridx_last``), the per-ear tail IDFT for both, and
the crossfade where ``xf > 0``.  Output: (S*nb, 2*fpb) = [L fpb | R fpb].

The arrays keep the JAX wrapper's layout; the TPU-only arguments (tile,
interpret, lane512, tail_tree, single_blend, mstack_tail, fwd512) are gone.
The kernel source is ``csrc/fused_step_onehot.cu``; its header says what
bounds it on the H100 and how its design answers that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..engine.renderer import blend_cat
from ..ops import fft as fft_ops
from ..ops.filters import cmul, distance_factors_split, xfade_ramp
from . import build

# Compact-table bucket above which the JAX package leaves the shared
# one-hot form (a TPU VMEM gate, batch._plan_batch_onehot).  The CUDA step
# reads the table through L2 and has no such limit; the batched renderer
# keeps the gate so it takes the one-hot form exactly where the JAX
# package does.
MAX_ONEHOT_U = 256

# Most unique (u_hi, u_lo, inv_frac) triples of the compact-distance form;
# its triple operand has 8 rows.
MAX_DIST_UNIQ = 8

# Launches of the CUDA kernel since the count was last set to 0.
launches: int = 0

_FPB, _PAD, _BINS = 128, 1024, 513  # the geometry the CUDA kernel is built for


def _in_table(idx, w, u: int):
    """An id outside the table matches no one-hot column of the TPU blend,
    so it contributes nothing: weight 0 on row 0."""
    ok = (idx >= 0) & (idx < u)
    return torch.where(ok, idx, 0), torch.where(ok, w, 0.0)


def fused_step_onehot_xfade_reference(
    streams, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf,
    *, nb: int, pad_len: int, bins: int, fpb: int, dsel=None, n_dist=None,
):
    """Plain-PyTorch twin of the CUDA step: the same function, in the JAX
    package's op order, on any device (see fused_step_onehot_xfade)."""
    s = streams.shape[0]
    b = s * nb
    xr, xi = fft_ops.rfft_sliding_split_batched(streams, nb, fpb, pad_len)
    xr, xi = xr.reshape(b, bins), xi.reshape(b, bins)
    dr, di = distance_factors_split(uh[:, 0], ul[:, 0], fr[:, 0], bins)
    if n_dist is not None:  # each row takes the planes of its own triple
        sel = dsel[:, 0].long()
        # a selector outside 1..n_dist-1 takes triple 0, as on the TPU
        sel = torch.where((sel > 0) & (sel < n_dist), sel, 0)
        dr, di = dr[sel], di[sel]
    xdr, xdi = cmul(xr, xi, dr, di)
    u = table.shape[0]
    g_old = blend_cat(table, *_in_table(ridx, w, u))             # (B, 4*bins)
    g_last = blend_cat(table, *_in_table(ridx_last, w_last, u))  # (S, 4*bins)
    g_new = torch.cat([g_old.reshape(s, nb, -1)[:, 1:], g_last[:, None]], dim=1)
    g_new = g_new.reshape(b, -1)
    fn = xfade_ramp(fpb, streams.device)
    on = xf > 0
    a = torch.where(on, 1.0 - fn, 0.0)
    bw = torch.where(on, fn, 1.0)

    def tail(g, ear):
        gr = g[:, 2 * ear * bins : (2 * ear + 1) * bins]
        gi = g[:, (2 * ear + 1) * bins : (2 * ear + 2) * bins]
        return fft_ops.irfft_tail_split(*cmul(xdr, xdi, gr, gi), pad_len, fpb)

    return torch.cat([tail(g_old, e) * a + tail(g_new, e) * bw for e in range(2)], dim=1)


@functools.cache
def _kernel():
    fn = build.load("fused_step_onehot").jt_fused_step_onehot_xfade
    ptr, num = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        num, ptr, ptr, num, num,      # device, stream, streams, sources, nb
        ptr, ptr, ptr, ptr, num,      # uh, ul, fr, dsel, n_dist
        ptr, num, ptr, ptr,           # table, its rows, ridx, w
        ptr, ptr, ptr,                # ridx_last, w_last, xf
        ptr, ptr, ptr, ptr, ptr, ptr,  # cfr, cfi, twr, twi, icr, ici
        ptr, ptr, ptr,                # xdr, xdi scratch, out
    ]
    fn.restype = num
    return fn


def _cuda_error(code: int) -> str:
    lib = build.load("fused_step_onehot")
    lib.jt_error_string.argtypes = [ctypes.c_int]
    lib.jt_error_string.restype = ctypes.c_char_p
    return lib.jt_error_string(code).decode()


def fused_step_onehot_xfade(
    streams,     # (S, (q-1)*fpb + nb*fpb) history followed by the fed samples
    uh, ul, fr,  # (S*nb, 1) distance phase split; (8, 1) triples with dsel
    table,       # (U_pad, 4*bins) compact filter table [rL | iL | rR | iR]
    ridx,        # (S*nb, 4) int32 old-row filter ids, remapped into table
    w,           # (S*nb, 4) float32 bracket weights
    ridx_last,   # (S, 4) int32 per-source final new rows
    w_last,      # (S, 4)
    xf,          # (S*nb, 1) float32 crossfade mask (> 0: crossfade)
    *, nb: int, pad_len: int, bins: int, fpb: int,
    dsel=None,   # (S*nb, 1) int32 triple selector (compact distance)
    n_dist: int | None = None,
) -> torch.Tensor:
    """-> (S*nb, 2*fpb) crossfaded stereo tails.

    Operands on the CPU run the plain twin; operands on a CUDA device run
    the CUDA kernel, or this raises (no fallback).  The CUDA kernel is
    built for fpb 128, pad_len 1024 and 513 bins.  Both keep the TPU
    kernel's answer for ids outside the table (they add nothing) and for
    selectors outside 1..n_dist-1 (triple 0), so no check syncs the device."""
    global launches
    s = streams.shape[0]
    q = pad_len // fpb
    if streams.shape[1] != nb * fpb + (q - 1) * fpb:
        raise ValueError(f"streams {tuple(streams.shape)} do not hold {nb} blocks + history")
    if (dsel is None) != (n_dist is None):
        raise ValueError("dsel and n_dist go together (compact distance)")
    operands = [streams, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf]
    if dsel is not None:
        operands.append(dsel)
    device = streams.device
    if any(t.device != device for t in operands):
        raise ValueError("all operands must lie on one device")
    kw = dict(nb=nb, pad_len=pad_len, bins=bins, fpb=fpb, dsel=dsel, n_dist=n_dist)
    if device.type == "cpu":
        return fused_step_onehot_xfade_reference(
            streams, uh, ul, fr, table, ridx, w, ridx_last, w_last, xf, **kw
        )
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if (fpb, pad_len, bins) != (_FPB, _PAD, _BINS):
        raise ValueError(f"the CUDA step is built for fpb={_FPB}, pad_len={_PAD}, bins={_BINS}")
    b = s * nb
    n_trip = b if dsel is None else uh.shape[0]
    shapes = {
        "uh": (uh, (n_trip, 1), torch.float32), "ul": (ul, (n_trip, 1), torch.float32),
        "fr": (fr, (n_trip, 1), torch.float32),
        "table": (table, (table.shape[0], 4 * bins), torch.float32),
        "ridx": (ridx, (b, 4), torch.int32), "w": (w, (b, 4), torch.float32),
        "ridx_last": (ridx_last, (s, 4), torch.int32), "w_last": (w_last, (s, 4), torch.float32),
        "xf": (xf, (b, 1), torch.float32), "streams": (streams, tuple(streams.shape), torch.float32),
    }
    if dsel is not None:
        shapes["dsel"] = (dsel, (b, 1), torch.int32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dsel is not None and not 1 <= n_dist <= n_trip:
        raise ValueError(f"n_dist={n_dist} outside 1..{n_trip}")
    if table.shape[0] < 1 or b < 1:
        raise ValueError("the step needs a table row and a block")

    cfr, cfi = fft_ops.on_device(fft_ops._subblock_dft_matrices, pad_len, fpb, device=device)
    twr, twi = fft_ops.on_device(fft_ops._sliding_twiddles, pad_len, fpb, device=device)
    icr, ici = fft_ops.on_device(fft_ops._idft_tail_matrices, pad_len, fpb, device=device)
    # The kernel runs after this returns; the scratch planes it still reads
    # are freed here, which is safe because the caching allocator hands
    # them out again only in order on this same stream.
    xdr = torch.empty((b, bins), dtype=torch.float32, device=device)
    xdi = torch.empty_like(xdr)
    out = torch.empty((b, 2 * fpb), dtype=torch.float32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _kernel()(
        device.index, torch.cuda.current_stream(device).cuda_stream,
        ptr(streams), s, nb, ptr(uh), ptr(ul), ptr(fr), ptr(dsel), n_dist or 0,
        ptr(table), table.shape[0], ptr(ridx), ptr(w), ptr(ridx_last), ptr(w_last), ptr(xf),
        ptr(cfr), ptr(cfi), ptr(twr), ptr(twi), ptr(icr), ptr(ici),
        ptr(xdr), ptr(xdi), ptr(out),
    )
    if err:
        raise RuntimeError(f"fused_step_onehot launch failed: CUDA error {err} ({_cuda_error(err)})")
    launches += 1
    return out
