"""The double-buffered row-gather blend (row 12): its CUDA kernel, its
plain-PyTorch twin, and the wrapper that picks one by where the operands
lie.

Counterpart of ``scripts/bench_blend_variants.py`` ``pallas_dma_blend``
(:98), body ``kernel`` (:55), with its signature and checks: per row r of
``idx`` and ``w`` (R, 4), out[r] = w0*T[i0] + w1*T[i1] + w2*T[i2] + w3*T[i3]
in that order, from the flat table ``table_flat`` (H*c_pad,) whose rows are
padded to ``c_pad`` (a multiple of 128) -> (R, c_pad).  ``tb``, the TPU's
rows per tile, must divide R; the CUDA kernel picks its own tile
(``csrc/dma_blend.cu``, whose header says what bounds it on the H100).

An id outside [0, H) contributes nothing (row 0 at weight 0), on the
kernel and the twin alike, as ``fused_step._in_table`` does for rows 1-4;
the kernel never reads outside the table.  The kernel rounds every product
and sum on its own in bracket order, so its output is the twin's, and the
torch gathers', bit for bit.  Operands on the CPU run the twin; on a CUDA
device the kernel runs or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fused_step import _check, _cuda_error, _in_table, _one_device, blend_cat, launches


def dma_blend_reference(table_flat, idx, w, c_pad: int, tb: int = 256):
    """Plain-PyTorch twin of row 12: ``blend_cat`` on the unflattened table,
    ids outside it at weight 0 on row 0."""
    table = table_flat.view(-1, c_pad)
    return blend_cat(table, *_in_table(idx, w, table.shape[0]))


@functools.cache
def _entry():
    fn = build.load("dma_blend").jt_dma_blend
    p, i = ctypes.c_void_p, ctypes.c_int
    # device, stream, table, h, c_pad, idx, w, out, rows
    fn.argtypes = [i, p, p, i, i, p, p, p, i]
    fn.restype = i
    return fn


def dma_blend(table_flat, idx, w, c_pad: int, tb: int = 256):
    """Row 12 -> (R, c_pad) float32; counted as ``dma_blend``."""
    if idx.dim() != 2 or table_flat.dim() != 1:
        raise ValueError(f"want a flat table and (R, 4) ids, got {tuple(table_flat.shape)} "
                         f"and {tuple(idx.shape)}")
    r = idx.shape[0]
    if tb < 1 or r % tb or c_pad < 128 or c_pad % 128:
        raise ValueError(f"R={r} must be a multiple of tb={tb}, and c_pad={c_pad} a positive "
                         f"multiple of 128")
    if table_flat.numel() % c_pad:
        raise ValueError(f"table of {table_flat.numel()} floats is not whole rows of {c_pad}")
    h = table_flat.numel() // c_pad
    _check({"table_flat": (table_flat, (h * c_pad,), torch.float32),
            "idx": (idx, (r, 4), torch.int32), "w": (w, (r, 4), torch.float32)})
    device = _one_device([table_flat, idx, w])
    if device.type == "cpu":
        return dma_blend_reference(table_flat, idx, w, c_pad, tb)
    if r < 1 or h < 1:
        raise ValueError(f"the blend needs a row and a table row, got R={r}, H={h}")
    if table_flat.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary (its rows are copied "
                         "16 bytes at a time)")
    out = torch.empty((r, c_pad), dtype=torch.float32, device=device)
    err = _entry()(device.index, torch.cuda.current_stream(device).cuda_stream,
                   table_flat.data_ptr(), h, c_pad, idx.data_ptr(), w.data_ptr(),
                   out.data_ptr(), r)
    if err:
        raise RuntimeError(f"dma_blend launch failed: CUDA error {err} "
                           f"({_cuda_error('dma_blend', err)})")
    launches["dma_blend"] += 1
    return out
