"""Kernel row 8, the full-table blend-apply-tail step: its CUDA kernel, its
plain PyTorch twin, and the wrappers that pick one by where the operands
lie.

Counterpart of ``jefferson_tpu/pallas/fused_spatializer.py`` ``fused_apply``
(:102, body ``_kernel`` :46, the ``pl.pallas_call`` at :126).  Per row r, on
the distance-multiplied forward planes XD[r]:

    G_side[r] = sum_j w_side[r, j] * T[idx_side[r, j]]   side = old, new
    y_side    = tail IDFT of XD[r] * G_side[r], per ear
    out[r]    = y_old * (1 - n/127) + y_new * n/127 where xf[r] > 0, else y_new

with T the whole filter table [rL | iL | rR | iR] (710 x 2052 floats,
5.8 MB) -> (rows, 2*fpb) = [L fpb | R fpb].  The TPU kernel returns the four
tails and its wrapper crossfades them; here the crossfade is the kernel's
epilogue, as in rows 1-7.  ``fused_forward_apply`` runs launch A first, on
one stream of blocks (its few-block form at the live block step's one row,
its product form for the scan render of ``engine/stream``).

On the card it runs in one of three forms, chosen by the row count (the
choice of shape, not a fallback: each raises on a build or launch error),
all behind the entry ``jt_fused_spatializer_apply`` of
``csrc/fused_step_onehot.cu``:

* the cluster form (``rows <= SMALL_ROWS``: the live block step's one row):
  one thread-block cluster of five CTAs per row, one per 128-bin block of
  the tail, the block partials folded in rank 0 through distributed shared
  memory;
* launch B (above it: ``render_scan``'s chunks, ``MANY_ROWS_FORM``): the
  one-hot step with segments of one row, each row's new side reading its
  own new brackets, and the whole table as one group; one CTA per 32 rows;
* or launch B's split form there: one cluster of CTAs per tile, one per
  128-bin block (``csrc/fused_forward.cuh``).

All keep the blocked tail's order, so they agree bit for bit.  The
cluster form exists at fpb 128 / pad 1024 alone and the split form where
``fused_step.geometry_forms`` says so; at other geometries ``pick_form``
takes the split form where it exists, but at the row counts where launch B
measured less device time (``fused_step.LAUNCH_B_SPANS``), else launch B,
and a form a geometry lacks, named through ``_cuda``, raises.
``fused_apply`` runs at a history of partial blocks too (the streaming
forms' card step there); ``fused_forward_apply`` needs whole blocks.

What bounds row 8 on the H100: at many rows the tail IDFT's fp32 FMAs
(two sides x two ears x 513 x 128 per row) on the CUDA cores; at one row
the launch and one 128-step chain.  The table stays in the 50 MB L2 and a row reads only its
eight bracket rows from it.

Where the two versions differ in rounding only: the TPU kernel's one-hot
product adds duplicate brackets' weights before multiplying by the table
row, the gather multiplies each bracket and sums; the TPU form needs
B % tb == 0, this takes any B >= 1.  An id outside the table matches no
one-hot column on the TPU and adds nothing; the kernels and the twin give
it weight 0 on row 0.  Operands on the CPU run the twin; on a CUDA device
the kernel runs or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import fft as fft_ops
from . import build
from .fused_step import (
    LAUNCH_B, SPATIALIZER, SPLIT, _check, _check_streams, _cuda_error, _forward_reference,
    _in_table, _tails_reference, _where, _whole_blocks, blend_cat, forward_form,
    forward_launches, geometry_forms, launch_b_span, launches, planes_scratch,
    spatializer_forms,
)

# Rows up to which row 8 takes the cluster form, and above which
# MANY_ROWS_FORM: on an H100 (700 W) the cluster form took less device time
# than the split form at every count of 1-128 rows and the split form at
# 256-1,024 (the cluster form grows about 0.36 us a row, the split form
# holds about 0.06 ms to 512 rows; chip_smoke.py, phase bench; PERF.md,
# the kernel table).  The live block step runs 1 row, render_scan chunks of up to 16,384.
SMALL_ROWS = 128
CLUSTER = "cluster"
# The form above SMALL_ROWS: launch B, or its split form (a cluster of CTAs
# per tile, one per 128-bin block, csrc/fused_forward.cuh), the one that
# took less device time alone at render_scan's 12,556 rows (chip_smoke.py,
# phase bench).  At the other geometries it takes launch B at the counts of
# fused_step.LAUNCH_B_SPANS["row 8"].
MANY_ROWS_FORM = SPLIT
_FORM_CODE = {LAUNCH_B: 0, CLUSTER: 1, SPLIT: 2}


def pick_form(rows: int, fpb: int = 128, pad_len: int = 1024) -> str:
    """Row 8's form on the card for ``rows`` rows, among those of the
    (fpb, pad_len) library."""
    forms = geometry_forms(fpb, pad_len)
    if rows <= SMALL_ROWS and forms.cluster:
        return CLUSTER
    if not forms.split or launch_b_span("row 8", rows, fpb, pad_len):
        return LAUNCH_B
    return MANY_ROWS_FORM


def kernel_planes(db, device) -> torch.Tensor:
    """The full filter table (num_hrtf, 4*bins) = [rL | iL | rR | iR] on
    ``device``: the JAX ``kernel_planes``' four planes side by side."""
    sp = np.asarray(db.spectra)
    re, im = np.real(sp), np.imag(sp)
    cat = np.concatenate([re[:, 0], im[:, 0], re[:, 1], im[:, 1]], axis=1)
    return torch.tensor(cat, dtype=torch.float32, device=device)


def fused_apply_reference(table, xdr, xdi, idx_old, w_old, idx_new, w_new, xf, *,
                          bins: int, fpb: int):
    """Plain-PyTorch twin of row 8 (see fused_apply)."""
    n = table.shape[0]
    g_old = blend_cat(table, *_in_table(idx_old, w_old, n))
    g_new = blend_cat(table, *_in_table(idx_new, w_new, n))
    return _tails_reference(xdr, xdi, g_old, g_new, xf, pad_len=2 * (bins - 1), bins=bins, fpb=fpb)


def fused_forward_apply_reference(table, stream, uh, ul, fr, idx_old, w_old, idx_new, w_new, xf,
                                  *, pad_len: int, bins: int, fpb: int):
    """Plain-PyTorch twin of the forward and row 8 (see fused_forward_apply)."""
    xdr, xdi = _forward_reference(stream[None], idx_old.shape[0], uh, ul, fr, None, None,
                                  pad_len=pad_len, bins=bins, fpb=fpb)
    return fused_apply_reference(table, xdr, xdi, idx_old, w_old, idx_new, w_new, xf,
                                 bins=bins, fpb=fpb)


@functools.cache
def _entry(geometry: tuple[int, int]):
    fn = build.load("fused_step_onehot", geometry=geometry).jt_fused_spatializer_apply
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, i, i,           # device, stream, rows, form
                   p, p, p, p,           # streams, uh, ul, fr
                   p, p, p, p, p, p,     # cfr, cfi, twr, twi, xdr, xdi
                   p, p,                 # pr, pi: launch A's planes form's scratch
                   p, i, p, p, p, p, p,  # table, its rows, idx_old, w_old, idx_new, w_new, xf
                   p, p, p]              # icr, ici, out
    fn.restype = ctypes.c_int
    return fn


def _cuda(device, rows: int, table, brackets, xf, xdr, xdi, forward, *, pad_len, bins, fpb,
          form=None):
    """Row 8 on the card in ``form`` (None: ``pick_form``; the card tests
    name a form to hold the forms against each other); ``forward`` =
    (stream, uh, ul, fr) runs launch A into xdr/xdi first, None reads them."""
    form = pick_form(rows, fpb, pad_len) if form is None else form
    if form not in _FORM_CODE:
        raise ValueError(f"form {form!r}: want {CLUSTER!r}, {LAUNCH_B!r} or {SPLIT!r}")
    forms = geometry_forms(fpb, pad_len)
    if (form == CLUSTER and not forms.cluster) or (form == SPLIT and not forms.split):
        raise ValueError(f"the {form} form does not exist at fpb {fpb}, pad {pad_len}")
    if forward is not None:
        _whole_blocks(fpb, pad_len)
    idx_old, w_old, idx_new, w_new = brackets
    specs = {
        "table": (table, (table.shape[0], 4 * bins), torch.float32),
        "idx_old": (idx_old, (rows, 4), torch.int32), "w_old": (w_old, (rows, 4), torch.float32),
        "idx_new": (idx_new, (rows, 4), torch.int32), "w_new": (w_new, (rows, 4), torch.float32),
        "xf": (xf, (rows, 1), torch.float32),
        "xdr": (xdr, (rows, bins), torch.float32), "xdi": (xdi, (rows, bins), torch.float32),
    }
    if forward is not None:
        stream, uh, ul, fr = forward
        specs["stream"] = (stream, tuple(stream.shape), torch.float32)
        specs.update({a: (t, (rows, 1), torch.float32) for a, t in (("uh", uh), ("ul", ul), ("fr", fr))})
    _check(specs)
    if rows < 1 or table.shape[0] < 1:
        raise ValueError("the step needs a table row and a block")
    ptr = lambda t: None if t is None else t.data_ptr()
    fwd, planes = [None] * 8, (None, None)
    if forward is not None:
        bases = (fft_ops.on_device(fft_ops._subblock_dft_matrices, pad_len, fpb, device=device)
                 + fft_ops.on_device(fft_ops._sliding_twiddles, pad_len, fpb, device=device))
        fwd = [ptr(t) for t in (*forward, *bases)]
        planes = planes_scratch(1, rows, fpb, pad_len, device)
    icr, ici = fft_ops.on_device(fft_ops._idft_tail_matrices, pad_len, fpb, device=device)
    out = torch.empty((rows, 2 * fpb), dtype=torch.float32, device=device)
    err = _entry((fpb, pad_len))(
        device.index, torch.cuda.current_stream(device).cuda_stream, rows, _FORM_CODE[form],
        *fwd, ptr(xdr), ptr(xdi), *(ptr(t) for t in planes), ptr(table), table.shape[0],
        *(ptr(t) for t in brackets),
        ptr(xf), ptr(icr), ptr(ici), ptr(out),
    )
    if err:
        raise RuntimeError(f"{SPATIALIZER} launch failed: CUDA error {err} "
                           f"({_cuda_error('fused_step_onehot', err, (fpb, pad_len))})")
    launches[SPATIALIZER] += 1
    spatializer_forms[form] += 1
    if forward is not None:
        forward_launches[forward_form(rows, fpb, pad_len)] += 1
    return out


def fused_apply(
    table,       # (num_hrtf, 4*bins) float32 the full table [rL | iL | rR | iR]
    xdr, xdi,    # (B, bins) float32 forward planes times the distance planes
    idx_old,     # (B, 4) int32 old brackets, ids into table
    w_old,       # (B, 4) float32
    idx_new,     # (B, 4) int32 new brackets
    w_new,       # (B, 4) float32
    xf,          # (B, 1) float32 crossfade mask (> 0: crossfade)
    *, bins: int, fpb: int,
) -> torch.Tensor:
    """Row 8 on the caller's XD planes -> (B, 2*fpb); counted as
    ``fused_spatializer_apply``."""
    operands = [table, xdr, xdi, idx_old, w_old, idx_new, w_new, xf]
    device = _where(operands, 2 * (bins - 1), bins, fpb)
    if device.type == "cpu":
        return fused_apply_reference(*operands, bins=bins, fpb=fpb)
    return _cuda(device, xdr.shape[0], table, (idx_old, w_old, idx_new, w_new), xf, xdr, xdi,
                 None, pad_len=2 * (bins - 1), bins=bins, fpb=fpb)


def fused_forward_apply(
    table,       # (num_hrtf, 4*bins) float32 the full table
    stream,      # ((q-1)*fpb + B*fpb,) float32 history followed by the B fed blocks
    uh, ul, fr,  # (B, 1) float32 per-row distance phase split
    idx_old, w_old, idx_new, w_new,  # (B, 4) brackets, as in fused_apply
    xf,          # (B, 1) float32 crossfade mask
    *, pad_len: int, bins: int, fpb: int, scratch=None,
) -> torch.Tensor:
    """The sliding forward DFT of ``stream``'s B windows times the distance
    planes (launch A), then row 8 -> (B, 2*fpb); one launch of row 8,
    counted as ``fused_spatializer_apply``.  ``scratch``: a (xdr, xdi) pair
    of (B, bins) float32 tensors that receive XD (default: allocated)."""
    rows = idx_old.shape[0]
    _check_streams(stream, rows, pad_len, fpb)
    operands = [table, stream, uh, ul, fr, idx_old, w_old, idx_new, w_new, xf]
    device = _where(operands + list(scratch or ()), pad_len, bins, fpb)
    if device.type == "cpu":
        xdr, xdi = _forward_reference(stream[None], rows, uh, ul, fr, None, None,
                                      pad_len=pad_len, bins=bins, fpb=fpb)
        if scratch is not None:
            scratch[0].copy_(xdr)
            scratch[1].copy_(xdi)
        return fused_apply_reference(table, xdr, xdi, idx_old, w_old, idx_new, w_new, xf,
                                     bins=bins, fpb=fpb)
    if scratch is None:
        scratch = tuple(torch.empty((rows, bins), dtype=torch.float32, device=device)
                        for _ in range(2))
    return _cuda(device, rows, table, (idx_old, w_old, idx_new, w_new), xf, *scratch,
                 (stream, uh, ul, fr), pad_len=pad_len, bins=bins, fpb=fpb)


def fused_apply_packed(table, xdr, xdi, idx8, w8, xfade, *, bins: int, fpb: int) -> torch.Tensor:
    """Row 8 with the JAX ``fused_apply``'s operands: (B, 8) ids and
    weights, old brackets then new, and a (B,) bool crossfade -> (B, fpb, 2)."""
    y = fused_apply(table, xdr, xdi, idx8[:, :4].contiguous(), w8[:, :4].contiguous(),
                    idx8[:, 4:].contiguous(), w8[:, 4:].contiguous(),
                    xfade.to(torch.float32)[:, None], bins=bins, fpb=fpb)
    return y.reshape(-1, 2, fpb).permute(0, 2, 1)
