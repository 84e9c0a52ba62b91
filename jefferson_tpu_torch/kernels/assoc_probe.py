"""The apply-association probe's kernels (rows 9-11): CUDA kernels, their
plain-PyTorch twins, and the wrappers that pick one by where the operands
lie.

Counterparts of the TPU kernels of ``scripts/apply_assoc_probe.py``, which
ask where the fused apply stage's rounding departs from the unfused chain:

====================  ====  ==========================================
wrapper               row   TPU kernel (site -> body)
====================  ====  ==========================================
prod                  9     ``prod_pallas`` (:69) -> ``_prod_kernel`` (:60)
mm                    10    ``mm_pallas`` (:97) -> ``_mm_kernel`` (:84)
mm_tree               11    ``mm_pallas_tree`` (:145) -> ``_mm_tree_kernel``
                            (:116)
====================  ====  ==========================================

All three live in ``csrc/assoc_probe.cu``, whose header says what bounds
them on the H100.  Rows and K are taken from the shapes.  Operands on the
CPU run the twin (``<name>_reference``); operands on a CUDA device run the
kernel, or the wrapper raises (no fallback).  The twins are eager torch:
on the card their matmuls are cuBLAS in full fp32 (the package turns TF32
off on import).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .fused_step import _check, _cuda_error, _one_device, launches

MAX_CHUNKS = 16      # K slices of row 11 (csrc/assoc_probe.cu MAX_CHUNKS)


def prod_reference(xr, xi, gr, gi):
    """Plain-PyTorch twin of row 9: (xr*gr - xi*gi, xr*gi + xi*gr), each
    product rounded on its own."""
    return xr * gr - xi * gi, xr * gi + xi * gr


def mm_reference(qr, qi, icr, ici):
    """Plain-PyTorch twin of row 10: qr @ icr + qi @ ici."""
    return qr @ icr + qi @ ici


def tree(parts):
    """The probe's pairwise sum: neighbours added level by level, an odd
    last part carried (a copy of ``_mm_tree_kernel``'s ``tree``)."""
    while len(parts) > 1:
        parts = [
            parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
            for i in range(0, len(parts), 2)
        ]
    return parts[0]


def _chunk_width(k: int, chunks: int) -> int:
    """K per chunk.  The TPU body cuts ``k // chunks`` and drops the last
    ``k % chunks`` columns without a word; the port refuses them."""
    if not 1 <= chunks <= MAX_CHUNKS:
        raise ValueError(f"chunks={chunks}: the kernel takes 1..{MAX_CHUNKS}")
    if k % chunks:
        raise ValueError(f"chunks={chunks} does not divide K={k}")
    return k // chunks


def mm_tree_reference(qr, qi, icr, ici, chunks: int):
    """Plain-PyTorch twin of row 11: per plane the chunk matmuls summed by
    ``tree``, then real + imag."""
    ck = _chunk_width(qr.shape[1], chunks)

    def chunked(q, basis):
        return tree([q[:, c * ck : (c + 1) * ck] @ basis[c * ck : (c + 1) * ck]
                     for c in range(chunks)])

    return chunked(qr, icr) + chunked(qi, ici)


@functools.cache
def _lib():
    lib = build.load("assoc_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jt_prod.argtypes = [i, p, p, p, p, p, p, p, ctypes.c_longlong]
    lib.jt_prod.restype = i
    lib.jt_mm_tree.argtypes = [i, p, p, p, p, p, p, i, i, i, i]
    lib.jt_mm_tree.restype = i
    return lib


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({_cuda_error('assoc_probe', err)})")


def _refuse_prod(xr, xi, gr, gi):
    """Raise for row 9's operands: a plane not contiguous float32 of xr's
    shape, or planes on more than one device."""
    _check({name: (t, tuple(xr.shape), torch.float32)
            for name, t in (("xr", xr), ("xi", xi), ("gr", gr), ("gi", gi))})
    _one_device([xr, xi, gr, gi])


def prod(xr, xi, gr, gi):
    """Row 9: the elementwise complex product of four (rows, K) float32
    planes -> (qr, qi); counted as ``prod``.  The operands are checked
    without building containers and the stream taken in one call: on the
    card the call is the host's launch path, and it is what row 9 costs."""
    shape, device = xr.shape, xr.device
    for t in (xr, xi, gr, gi):
        if (t.dtype is not torch.float32 or t.shape != shape or t.device != device
                or not t.is_contiguous()):
            _refuse_prod(xr, xi, gr, gi)
    if device.type != "cuda":
        _one_device([xr])  # the CPU's twin, or no kernel at all
        return prod_reference(xr, xi, gr, gi)
    qr, qi = torch.empty_like(xr), torch.empty_like(xr)
    n = xr.numel()
    if n:
        err = _lib().jt_prod(device.index, torch._C._cuda_getCurrentRawStream(device.index),
                             xr.data_ptr(), xi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                             qr.data_ptr(), qi.data_ptr(), n)
        if err:
            _raise_on("prod", err)
        launches["prod"] += 1
    return qr, qi


def _mm(name: str, qr, qi, icr, ici, chunks: int):
    if qr.dim() != 2 or icr.dim() != 2:
        raise ValueError(f"{name}: want 2-D planes, got {tuple(qr.shape)} and {tuple(icr.shape)}")
    m, k = qr.shape
    n = icr.shape[1]
    _check({"qr": (qr, (m, k), torch.float32), "qi": (qi, (m, k), torch.float32),
            "icr": (icr, (k, n), torch.float32), "ici": (ici, (k, n), torch.float32)})
    _chunk_width(k, chunks)
    device = _one_device([qr, qi, icr, ici])
    if device.type == "cpu":
        return mm_reference(qr, qi, icr, ici) if name == "mm" else \
            mm_tree_reference(qr, qi, icr, ici, chunks)
    if min(m, k, n) < 1:
        raise ValueError(f"{name}: empty operands {tuple(qr.shape)} x {tuple(icr.shape)}")
    y = torch.empty((m, n), dtype=torch.float32, device=device)
    err = _lib().jt_mm_tree(device.index, torch.cuda.current_stream(device).cuda_stream,
                            qr.data_ptr(), qi.data_ptr(), icr.data_ptr(), ici.data_ptr(),
                            y.data_ptr(), m, k, n, chunks)
    _raise_on(name, err)
    launches[name] += 1
    return y


def mm(qr, qi, icr, ici):
    """Row 10: y (rows, N) = qr @ icr + qi @ ici for (rows, K) q planes and
    (K, N) basis planes, one chain per plane in ascending k; counted as
    ``mm``."""
    return _mm("mm", qr, qi, icr, ici, 1)


def mm_tree(qr, qi, icr, ici, chunks: int):
    """Row 11: row 10 with K cut into ``chunks`` slices (1..16, dividing K),
    each plane's slice products summed by ``tree``; counted as
    ``mm_tree``."""
    return _mm("mm_tree", qr, qi, icr, ici, chunks)
