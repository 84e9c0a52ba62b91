"""The row-gather blend (row 12): its CUDA kernel in two forms, its
plain-PyTorch twin, and the wrappers that pick one by where the operands
lie: ``dma_blend``, the probe's, and ``blend_rows``, rows 5-7's pre-blend
on the render path.

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

On the card the kernel has two forms with the same bits: the dedup form
(32 rows a CTA, each distinct table row the tile names staged once a
column slice), which the wrappers take at every row count (on an H100 at
700 W it took less device time alone than the other at every count
measured, 16-8,448 rows: chip_smoke.py, phase bench), and the
double-buffered form (8 rows x 1,024 columns a CTA, the first), kept to
hold it against through ``_cuda(..., form=DOUBLE)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fused_step import (
    DEDUP, DOUBLE, _check, _cuda_error, _in_table, _one_device, blend_cat, blend_forms, launches,
)

_FORM_CODE = {DOUBLE: 0, DEDUP: 1}

# The dedup form's tile and column slices (csrc/dma_blend.cu DD_ROWS,
# DD_W4): rows a tile, whose distinct ids it stages once a slice, and
# float4 columns a slice at most.
DEDUP_ROWS, DEDUP_W4 = 32, 32


def dedup_slices(c: int) -> list[tuple[int, int]]:
    """The dedup form's column slices of a row of ``c`` floats, as its
    kernel cuts them: [(first float, floats)], ceil(c / 128) slices of equal
    width in float4s, the last one short where they do not divide."""
    c4 = c // 4
    n = -(-c4 // DEDUP_W4)
    w4 = -(-c4 // n)
    return [(4 * s * w4, 4 * min(w4, c4 - s * w4)) for s in range(n)]


def dma_blend_reference(table_flat, idx, w, c_pad: int, tb: int = 256):
    """Plain-PyTorch twin of row 12: ``blend_cat`` on the unflattened table,
    ids outside it at weight 0 on row 0."""
    table = table_flat.view(-1, c_pad)
    return blend_cat(table, *_in_table(idx, w, table.shape[0]))


@functools.cache
def _form_entry():
    fn = build.load("dma_blend").jt_dma_blend_form
    p, i = ctypes.c_void_p, ctypes.c_int
    # device, stream, form, table, h, c, idx, w, out, rows
    fn.argtypes = [i, p, i, p, i, i, p, p, p, i]
    fn.restype = i
    return fn


def _cuda(table, idx, w, c: int, *, form: str = DEDUP):
    """The kernel on the card in ``form`` -> (R, c): ``table`` (H*c,) or
    (H, c), 16-byte aligned, ``idx`` (R, 4) int32 and ``w`` (R, 4) float32
    on one CUDA device, checked by the caller; counted as ``dma_blend``.
    The card tests and chip_smoke.py name the double-buffered form here."""
    if form not in _FORM_CODE:
        raise ValueError(f"form {form!r}: want {DOUBLE!r} or {DEDUP!r}")
    r, h = idx.shape[0], table.numel() // c
    if r < 1 or h < 1:
        raise ValueError(f"the blend needs a row and a table row, got R={r}, H={h}")
    if table.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary (its rows are copied "
                         "16 bytes at a time)")
    device = table.device
    out = torch.empty((r, c), dtype=torch.float32, device=device)
    err = _form_entry()(device.index, torch.cuda.current_stream(device).cuda_stream,
                        _FORM_CODE[form], table.data_ptr(), h, c, idx.data_ptr(), w.data_ptr(),
                        out.data_ptr(), r)
    if err:
        raise RuntimeError(f"dma_blend ({form}) launch failed: CUDA error {err} "
                           f"({_cuda_error('dma_blend', err)})")
    launches["dma_blend"] += 1
    blend_forms[form] += 1
    return out


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
    return _cuda(table_flat, idx, w, c_pad)


def blend_rows(table, idx, w):
    """Rows 5-7's pre-blend: ``blend_cat(table, idx, w)`` -> (R, C) float32,
    the weighted 4-row gather on the (U, C) combined table as
    ``renderer.cat_table`` builds it (C = 4*bins), summed in bracket order.

    On the CPU it is ``blend_cat``; on a CUDA device row 12's kernel runs
    (counted as ``dma_blend``) or this raises, with the same bits, and an id
    outside [0, U) adds nothing there (row 0 at weight 0) where
    ``blend_cat`` would index out of range.  ``idx`` (R, 4) of any integer
    type, ``w`` (R, 4) of any float type, as ``blend_cat`` takes them."""
    if table.dim() != 2 or idx.dim() != 2 or idx.shape[1] != 4 or tuple(w.shape) != tuple(idx.shape):
        raise ValueError(f"want a (U, C) table and (R, 4) ids and weights, got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)} and {tuple(w.shape)}")
    device = _one_device([table, idx, w])
    if device.type == "cpu":
        return blend_cat(table, idx, w)
    u, c = table.shape
    if table.dtype != torch.float32 or not table.is_contiguous() or c % 4:
        raise ValueError(f"the card blends a contiguous float32 table of rows that are a "
                         f"multiple of 4 floats, got {table.dtype} {tuple(table.shape)}")
    if idx.shape[0] == 0:
        return torch.empty((0, c), dtype=torch.float32, device=device)
    idx = idx.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    return _cuda(table, idx, w, c)
