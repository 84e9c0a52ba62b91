"""DFT ops: complex64 transforms on ``torch.fft`` (the ``fft`` backend) and
split-plane float32 matmuls (the ``matmul`` backend and the kernels' forms).

Counterpart of ``jefferson_tpu/ops/fft.py``.  The JAX module's ``rfft`` and
``irfft`` are XLA's FFT ops, so their counterparts here are cuFFT's on the
card (pocketfft on the CPU).  The
NumPy basis builders below are verbatim copies of the JAX module's: the
sliding forward and the direct forward stay numerically in lockstep only
because ``_subblock_dft_matrices`` slices ``_dft_matrices`` (the
tail-association invariant), so the port must build *the same* bases.
``tests/test_torch_ops.py`` pins each copy bit-for-bit to the original.

Convention: the forward is unnormalized; the inverse bases carry the 1/N
and the 2x weight on interior bins.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _dft_matrices(n: int):
    """Forward real-DFT basis (n, bins) as float32 cos/sin matrices
    (NumPy; ``on_device`` makes the per-device tensor copies)."""
    bins = n // 2 + 1
    k = np.arange(bins)[None, :]
    t = np.arange(n)[:, None]
    ang = 2.0 * np.pi * t * k / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_matrices(n: int):
    """Inverse basis (bins, n): y = a @ Cr + b @ Ci with the 1/N and the
    2x weight on interior bins folded in (a=Re, b=Im of the half-spectrum)."""
    bins = n // 2 + 1
    k = np.arange(bins)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    w = np.full((bins, 1), 2.0)
    w[0, 0] = 1.0
    if n % 2 == 0:
        w[-1, 0] = 1.0
    cr = (w * np.cos(ang) / n).astype(np.float32)
    ci = (-w * np.sin(ang) / n).astype(np.float32)
    return cr, ci


@functools.lru_cache(maxsize=8)
def _subblock_dft_matrices(n: int, sub: int):
    """DFT basis of a length-``sub`` block zero-padded to n: (sub, bins)
    planes — exactly the first ``sub`` rows of the full basis, SLICED from
    it so the sliding forward and the direct rfft_split stay numerically
    in lockstep by construction (the tail-association invariant depends on
    these two paths agreeing)."""
    return tuple(np.ascontiguousarray(m[:sub]) for m in _dft_matrices(n))


@functools.lru_cache(maxsize=8)
def _sliding_twiddles(n: int, sub: int):
    """Twiddles e^{-2πi k (sub*m)/n} for m = 0..n/sub-1: (q, bins) planes."""
    q = n // sub
    bins = n // 2 + 1
    k = np.arange(bins)[None, :]
    m = np.arange(q)[:, None]
    ang = 2.0 * np.pi * k * m / q
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _idft_tail_matrices(n: int, tail: int):
    cr, ci = _idft_matrices(n)
    return np.ascontiguousarray(cr[:, n - tail :]), np.ascontiguousarray(ci[:, n - tail :])


@functools.lru_cache(maxsize=32)
def on_device(builder, *args, device: torch.device):
    """A NumPy basis builder's planes as float32 tensors on ``device``
    (built and copied once per device)."""
    return tuple(torch.from_numpy(m).to(device) for m in builder(*args))


def rfft(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """(…, n) real -> (…, n//2+1) complex64, unnormalized."""
    return torch.fft.rfft(x, n=n, dim=-1)


def irfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """(…, n//2+1) complex -> (…, n) real, with the 1/N.

    Like numpy's and XLA's irfft, it reads only the real part of the DC bin
    and, for even n, of the Nyquist bin.  cuFFT's C2R does not drop their
    imaginary parts (a distance factor's phase ramp leaves one on the
    Nyquist bin: 7.6e-4 off on an H100), so they are zeroed first."""
    edges = [k for k in ((0, n // 2) if n % 2 == 0 else (0,)) if k < x.shape[-1]]
    x = x.clone()
    x[..., edges] = x[..., edges].real.to(x.dtype)
    return torch.fft.irfft(x, n=n, dim=-1)


def rfft_matmul(x: torch.Tensor, n: int) -> torch.Tensor:
    """(…, n) real -> (…, n//2+1) complex64 via two fp32 matmuls."""
    cr, ci = on_device(_dft_matrices, n, device=x.device)
    return torch.complex(x @ cr, x @ ci)


def irfft_matmul(spec: torch.Tensor, n: int) -> torch.Tensor:
    """(…, n//2+1) complex -> (…, n) real via two fp32 matmuls (with the 1/N)."""
    cr, ci = on_device(_idft_matrices, n, device=spec.device)
    return spec.real @ cr + spec.imag @ ci


def get_backend(name: str):
    """'fft' -> torch.fft; 'matmul' -> the DFT as fp32 matmuls."""
    if name == "fft":
        return rfft, irfft
    if name == "matmul":
        return rfft_matmul, irfft_matmul
    raise ValueError(f"unknown fft backend {name!r}")


def rfft_split(x: torch.Tensor, n: int):
    """(…, n) real -> ((…, bins) re, (…, bins) im) float32 planes."""
    cr, ci = on_device(_dft_matrices, n, device=x.device)
    return x @ cr, x @ ci


def _twiddle_accumulate(pr, pi, num_blocks: int, q: int, twr, twi):
    """X[b] = sum_m tw[m] · P[b+m] along dim -2, in the JAX module's order:
    m = 0 first (twiddle 1), then m = 1..q-1 added one at a time."""
    xr = pr[..., 0:num_blocks, :]
    xi = pi[..., 0:num_blocks, :]
    for m in range(1, q):
        a, b = twr[m], twi[m]
        prm = pr[..., m : m + num_blocks, :]
        pim = pi[..., m : m + num_blocks, :]
        xr = xr + (a * prm - b * pim)
        xi = xi + (a * pim + b * prm)
    return xr, xi


# Samples a sub-block DFT sums in one product; a longer sub-block adds its
# 128-sample products in ascending order, the association of launch A's
# chains (csrc/fused_forward.cuh F_BLOCK): at 1,024 samples one product over
# K read about 1.5e-6 of the peak from float64, the blocked sum 2.6e-7.
DFT_BLOCK = 128


def _subblock_dft(subs: torch.Tensor, cr: torch.Tensor, ci: torch.Tensor):
    """(rows, sub) sub-blocks -> their (rows, bins) DFT planes, summed by
    ``DFT_BLOCK``-sample blocks in order above ``DFT_BLOCK`` samples."""
    sub = subs.shape[-1]
    if sub <= DFT_BLOCK:
        return subs @ cr, subs @ ci
    pr = pi = None
    for n0 in range(0, sub, DFT_BLOCK):
        a = subs[..., n0 : n0 + DFT_BLOCK]
        r, i = a @ cr[n0 : n0 + DFT_BLOCK], a @ ci[n0 : n0 + DFT_BLOCK]
        pr, pi = (r, i) if pr is None else (pr + r, pi + i)
    return pr, pi


def rfft_sliding_split(stream: torch.Tensor, num_blocks: int, sub: int, n: int):
    """Overlap-save windows' DFTs from the contiguous sample stream.

    stream: (num_blocks*sub + (n - sub),) — history followed by fed samples.
    Window b is stream[b*sub : b*sub + n]; its DFT is the sum over the
    q = n/sub zero-padded sub-block DFTs P[b..b+q-1] with q-th-root
    twiddles: X[b] = sum_m e^{-2πik m/q} P[b+m].
    """
    q = n // sub
    assert stream.shape[-1] == num_blocks * sub + (n - sub)
    subs = stream.reshape(num_blocks + q - 1, sub)
    cr, ci = on_device(_subblock_dft_matrices, n, sub, device=stream.device)
    twr, twi = on_device(_sliding_twiddles, n, sub, device=stream.device)
    return _twiddle_accumulate(*_subblock_dft(subs, cr, ci), num_blocks, q, twr, twi)


def rfft_sliding_split_batched(streams: torch.Tensor, num_blocks: int, sub: int, n: int):
    """Batched rfft_sliding_split: streams (S, num_blocks*sub + n - sub) ->
    ((S, num_blocks, bins) re, im).  The sub-block DFT is one tall matmul
    over all sources' sub-blocks (a blocked sum of them past 128 samples)."""
    q = n // sub
    s = streams.shape[0]
    rows = num_blocks + q - 1
    subs = streams.reshape(s * rows, sub)
    cr, ci = on_device(_subblock_dft_matrices, n, sub, device=streams.device)
    twr, twi = on_device(_sliding_twiddles, n, sub, device=streams.device)
    pr, pi = _subblock_dft(subs, cr, ci)
    return _twiddle_accumulate(pr.reshape(s, rows, -1), pi.reshape(s, rows, -1), num_blocks, q,
                               twr, twi)


def irfft_tail_split(re: torch.Tensor, im: torch.Tensor, n: int, tail: int) -> torch.Tensor:
    """Inverse of rfft_split, returning only the last ``tail`` samples."""
    cr, ci = on_device(_idft_tail_matrices, n, tail, device=re.device)
    return re @ cr + im @ ci


@functools.lru_cache(maxsize=8)
def _idft_tail_blocks(n: int, tail: int, block: int):
    """The tail basis by ``block``-bin blocks: per block its bins' rows of
    cr over those of ci, (2*len, tail)."""
    cr, ci = _idft_tail_matrices(n, tail)
    return tuple(np.concatenate([cr[k0:k0 + block], ci[k0:k0 + block]])
                 for k0 in range(0, cr.shape[0], block))


def irfft_tail(re: torch.Tensor, im: torch.Tensor, n: int, tail: int,
               block: int = 128) -> torch.Tensor:
    """The unfused chain's tail IDFT: ``irfft_tail_split``'s function summed
    by ``block``-bin blocks, per block one product of [re | im] by [cr ; ci]
    over its bins and the blocks added in ascending order, the association
    the fused kernels keep (their blocked tail).  On an H100 one product
    over all 513 bins read margin 1.0058 of the sweep gate on the worst
    scenario, the blocked sum 0.5588 (PERF.md; ROADMAP.md, queue 3)."""
    bases = on_device(_idft_tail_blocks, n, tail, block, device=re.device)
    x = torch.cat([p[..., k0:k0 + block] for k0 in range(0, re.shape[-1], block)
                   for p in (re, im)], -1)  # [re_0 | im_0 | re_1 | im_1 | ...]
    y, off = None, 0
    for basis in bases:
        part = x[..., off:off + basis.shape[0]] @ basis
        off += basis.shape[0]
        y = part if y is None else y + part
    return y
