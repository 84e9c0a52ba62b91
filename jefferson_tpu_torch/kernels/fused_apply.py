"""The apply-only fused step (kernel row 7): its CUDA kernel, its plain
PyTorch twin, and the wrapper that picks one by where the operands lie.

Counterpart of ``jefferson_tpu/pallas/fused_apply.py`` ``fused_apply_xfade``
(:133, body ``_kernel`` :59).  The caller computes the distance-multiplied
forward planes XD; per row r the step takes the old filter row g_old[r],
derives the new one (g_old[r+1] inside a segment of ``seg`` rows, the
segment's ``g_last`` row at its end), and computes the per-ear tail IDFT of
XD * G for both and the crossfade where ``xf > 0``.  ``with_xfade=False``:
``g_old`` carries the NEW rows and only their side is computed.  Output
(rows, 2*fpb) = [L fpb | R fpb].

On the card it is launch B of the gather step (``csrc/fused_step_gather.cu``,
``jt_fused_apply_xfade``) run on the caller's planes with the segment length
in place of the block count, so rows 5-7 share one tail loop, in either of
launch B's forms (``fused_step.pick_form``).  The TPU
kernel's tile rule (seg | tb or tb | seg) does not apply; the wrapper needs
only whole segments.  It runs at every geometry the card takes
(``fused_step.check_geometry``) from the (fpb, pad_len) library, a history
of partial blocks included: it is the card's step there (fpb 100 or 441
under pad 1024).  Operands on the CPU run the twin; on a CUDA device
the kernel runs or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fused_step import (
    _FORM_CODE, SPLIT, _check, _count, _cuda_error, _form, _tails_reference, _where,
)

NO_XFADE = "fused_apply_xfade/no_xfade"


def fused_apply_xfade_reference(xdr, xdi, g_old, g_last, xf, icr, ici, *, seg: int, bins: int,
                                fpb: int, with_xfade: bool = True):
    """Plain-PyTorch twin of row 7 (see fused_apply_xfade)."""
    kw = dict(pad_len=None, bins=bins, fpb=fpb, bases=(icr, ici))
    if not with_xfade:
        return _tails_reference(xdr, xdi, None, g_old, None, **kw)
    n_seg = g_old.shape[0] // seg
    g_new = torch.cat([g_old.reshape(n_seg, seg, -1)[:, 1:], g_last[:, None]], dim=1)
    return _tails_reference(xdr, xdi, g_old, g_new.reshape(g_old.shape), xf, **kw)


@functools.cache
def _entry(geometry: tuple[int, int]):
    fn = build.load("fused_step_gather", geometry=geometry).jt_fused_apply_xfade
    p, i = ctypes.c_void_p, ctypes.c_int
    # device, stream, xdr, xdi, rows, seg, g_rows, g_last, xf, with_xfade, form, icr, ici, out
    fn.argtypes = [i, p, p, p, i, i, p, p, p, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def fused_apply_xfade(
    xdr, xdi,    # (B, bins) float32 forward planes times the distance planes
    g_old,       # (B, 4*bins) old-filter rows [rL | iL | rR | iR]; NEW rows when not with_xfade
    g_last,      # (B/seg, 4*bins) each segment's final new row (None when not with_xfade)
    xf,          # (B, 1) float32 crossfade mask (None when not with_xfade)
    icr, ici,    # (bins, fpb) tail-IDFT planes
    *, seg: int, bins: int, fpb: int, with_xfade: bool = True,
) -> torch.Tensor:
    """Row 7 -> (B, 2*fpb); counted as ``fused_apply_xfade``, the
    no-crossfade form as ``fused_apply_xfade/no_xfade``."""
    b = xdr.shape[0]
    if seg < 1 or b % seg:
        raise ValueError(f"{b} rows do not split into segments of {seg}")
    if with_xfade and (g_last is None or xf is None):
        raise ValueError("the crossfade form needs g_last and xf")
    operands = [xdr, xdi, g_old, icr, ici] + ([g_last, xf] if with_xfade else [])
    pad_len = 2 * (bins - 1)
    device = _where(operands, pad_len, bins, fpb)
    if device.type == "cpu":
        return fused_apply_xfade_reference(xdr, xdi, g_old, g_last, xf, icr, ici, seg=seg,
                                           bins=bins, fpb=fpb, with_xfade=with_xfade)
    specs = {
        "xdr": (xdr, (b, bins), torch.float32), "xdi": (xdi, (b, bins), torch.float32),
        "g_old": (g_old, (b, 4 * bins), torch.float32),
        "icr": (icr, (bins, fpb), torch.float32), "ici": (ici, (bins, fpb), torch.float32),
    }
    if with_xfade:
        specs["g_last"] = (g_last, (b // seg, 4 * bins), torch.float32)
        specs["xf"] = (xf, (b, 1), torch.float32)
    _check(specs)
    if b < 1:
        raise ValueError("the step needs a block")
    name = "fused_apply_xfade" if with_xfade else NO_XFADE
    form = _form(name, b, fpb, pad_len)
    if form == SPLIT and fpb % 4 == 0 and (icr.data_ptr() % 16 or ici.data_ptr() % 16):
        raise ValueError("the split form copies the tail basis in 16-byte pieces: "
                         "icr and ici must start on a 16-byte boundary")
    out = torch.empty((b, 2 * fpb), dtype=torch.float32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _entry((fpb, pad_len))(
        device.index, torch.cuda.current_stream(device).cuda_stream,
        ptr(xdr), ptr(xdi), b, seg, ptr(g_old),
        ptr(g_last) if with_xfade else None, ptr(xf) if with_xfade else None, int(with_xfade),
        _FORM_CODE[form], ptr(icr), ptr(ici), ptr(out),
    )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({_cuda_error('fused_step_gather', err, (fpb, pad_len))})")
    _count(name, form)
    return out
