"""Convolution reverb: partitioned FFT convolution on the caller's device.
Counterpart of ``jefferson_tpu/reverb/convolution.py``.

The reference's preprocessing reverb is one whole-file cuFFT convolution
(reference: Jefferson/src/cudaPart.cu:81-196) at size
new_size = signal + ceil(ir/2) (PadData, reference:
Jefferson/src/kernels.cu:169-188), a circular convolution whose tail wraps
onto the start, then an RMS renormalization back to the input level (the
reference's renormalization call swaps its scale and size arguments and the
path is compiled out behind reverbFlag=false; the intended behaviour is
implemented).

Two backends:
  * ``"host"`` (the offline default): one scipy float64 FFT.
  * ``"device"``: uniform partitions of ``partition`` samples convolved in
    the frequency domain with the input's block spectra,
    ``y[m] = sum_j S[m-j] * H[j]`` per bin, on the caller's device (the
    card unless the caller asks for the CPU; a CUDA device without a card
    raises, and nothing falls back to ``"host"``).  The JAX package names
    this backend ``"tpu"`` and runs the sum as four grouped 1-D
    convolutions; here it is a direct sum over the J partitions of shifted
    real products, the same four sums, with no algorithm choice to change
    its rounding from call to call.  The streaming convolver is the same
    formulation, block by block.
The reference's circular semantics come from the linear result by folding
the tail back (``reverb_reference``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..engine.renderer import resolve_device
from ..ops import fft as fft_ops

BACKENDS = ("host", "device")


def _block_spectra_split(x: np.ndarray, part: int, fft_size: int, device: torch.device):
    """A 1-D signal in hop=part blocks, each zero-padded to fft_size ->
    stacked (M, bins) re/im spectra on ``device``."""
    n = len(x)
    m = max(1, -(-n // part))
    flat = np.zeros(m * part, dtype=np.float32)
    flat[:n] = x
    buf = np.zeros((m, fft_size), dtype=np.float32)
    buf[:, :part] = flat.reshape(m, part)
    return fft_ops.rfft_split(torch.from_numpy(buf).to(device), fft_size)


def _spectral_conv_blocks(sr, si, hr, hi):
    """y[m] = sum_j s[m-j] * h[j] per frequency bin, full length M+J-1: the
    four real sums of the complex product, each a sum over j of a shifted
    elementwise product, then yr = a - b and yi = c + d as in the JAX
    module's grouped convolutions."""
    m, j = sr.shape[0], hr.shape[0]
    sums = torch.zeros((4, m + j - 1, sr.shape[1]), dtype=sr.dtype, device=sr.device)
    for jj in range(j):
        rows = slice(jj, jj + m)
        sums[0, rows] += sr * hr[jj]
        sums[1, rows] += si * hi[jj]
        sums[2, rows] += sr * hi[jj]
        sums[3, rows] += si * hr[jj]
    return sums[0] - sums[1], sums[2] + sums[3]


def _overlap_add(y_blocks: torch.Tensor, part: int, fft_size: int, total: int) -> torch.Tensor:
    """(M, fft_size) time blocks at hop ``part`` -> (total,) overlap-added:
    each block's fft_size//part sub-chunks added at their shifts."""
    m = y_blocks.shape[0]
    acc = torch.zeros((m - 1) * part + 2 * fft_size, dtype=y_blocks.dtype,
                      device=y_blocks.device)
    for c in range(fft_size // part):
        acc[c * part : c * part + m * part] += y_blocks[:, c * part : (c + 1) * part].reshape(-1)
    return acc[:total]


def convolve_linear(
    signal: np.ndarray,
    ir: np.ndarray,
    config: EngineConfig = DEFAULT_CONFIG,
    partition: int | None = None,
    backend: str = "host",
    device="cuda",
) -> np.ndarray:
    """Full linear convolution (len = len(signal)+len(ir)-1), float32.

    ``backend="host"``: one float64 scipy FFT.  ``backend="device"``: the
    uniform partitioned frequency-domain convolution on ``device``
    (partitions of ``partition`` samples, config.pad_len by default)."""
    signal = np.asarray(signal, dtype=np.float32)
    ir = np.asarray(ir, dtype=np.float32)
    if backend not in BACKENDS:
        raise ValueError(f"unknown reverb backend {backend!r} (choose from {BACKENDS})")
    if len(ir) == 0:
        # a zero-length IR (a truncated or corrupt reverb WAV) fails loudly
        raise ValueError("reverb IR is empty")
    if backend == "host":
        import scipy.fft

        n = len(signal) + len(ir) - 1
        spec = scipy.fft.rfft(signal.astype(np.float64), n) * scipy.fft.rfft(
            ir.astype(np.float64), n
        )
        return scipy.fft.irfft(spec, n).astype(np.float32)
    device = resolve_device(device)
    part = partition or config.pad_len
    fft_size = 2 * part
    sr_, si_ = _block_spectra_split(signal, part, fft_size, device)
    hr_, hi_ = _block_spectra_split(ir, part, fft_size, device)
    yr, yi = _spectral_conv_blocks(sr_, si_, hr_, hi_)
    # the full inverse: overlap-add needs all fft_size samples of a block
    cr, ci = fft_ops.on_device(fft_ops._idft_matrices, fft_size, device=device)
    yt = yr @ cr + yi @ ci
    out = _overlap_add(yt, part, fft_size, len(signal) + len(ir) - 1)
    return out.cpu().numpy()


def reverb_reference(
    signal: np.ndarray,
    ir: np.ndarray,
    config: EngineConfig = DEFAULT_CONFIG,
    normalize: bool = True,
    backend: str = "host",
    device="cuda",
) -> np.ndarray:
    """The reference's preprocessing reverb with its intended semantics.

    Output length new_size = len(signal) + ceil(len(ir)/2); the linear
    convolution's tail past new_size wraps back onto the start (circular FFT
    convolution, reference: Jefferson/src/cudaPart.cu:124-153); the result
    is RMS-renormalized to the dry input level when ``normalize``."""
    signal = np.asarray(signal, dtype=np.float32)
    ir = np.asarray(ir, dtype=np.float32)
    min_radius = len(ir) // 2
    new_size = len(signal) + (len(ir) - min_radius)
    lin = convolve_linear(signal, ir, config, backend=backend, device=device)
    out = np.zeros(new_size, dtype=np.float32)
    # lin has len(signal)+len(ir)-1 samples, new_size-1 for a 1-tap IR:
    # copy what exists (the missing final sample is zero)
    head = lin[:new_size]
    out[: len(head)] = head
    tail = lin[new_size:]
    out[: len(tail)] += tail  # circular wrap (tail < new_size by construction)
    if normalize:
        rms_in = float(np.sqrt(np.mean(signal.astype(np.float64) ** 2)))
        rms_out = float(np.sqrt(np.mean(out.astype(np.float64) ** 2)))
        if rms_out > 0:
            out *= np.float32(rms_in / rms_out)
    return out


def reverb_oracle(signal: np.ndarray, ir: np.ndarray, normalize: bool = True) -> np.ndarray:
    """NumPy/scipy oracle of reverb_reference: a whole-signal FFT like the
    reference's, float64 accumulation."""
    import scipy.fft

    signal = np.asarray(signal, dtype=np.float64)
    ir = np.asarray(ir, dtype=np.float64)
    min_radius = len(ir) // 2
    new_size = len(signal) + (len(ir) - min_radius)
    n = new_size
    spec = scipy.fft.rfft(signal, n) * scipy.fft.rfft(ir, n)
    out = scipy.fft.irfft(spec, n)
    if normalize:
        rms_in = float(np.sqrt(np.mean(signal**2)))
        rms_out = float(np.sqrt(np.mean(out**2)))
        if rms_out > 0:
            out *= rms_in / rms_out
    return out.astype(np.float32)


class StreamingConvolver:
    """Uniform partitioned convolution with a frequency-domain delay line,
    the reverb's streaming form for block-by-block pipelines.

    Feed ``partition``-sized chunks; each call returns as many samples
    (latency: one partition).  The IR spectra, the ring of the last J input
    spectra and the overlap live on ``device`` (the card unless the caller
    asks for the CPU); only a chunk goes up and its output comes back."""

    def __init__(self, ir: np.ndarray, partition: int = 1024, device="cuda"):
        self.part = partition
        self.fft_size = 2 * partition
        ir = np.asarray(ir, dtype=np.float32)
        if len(ir) == 0:
            # an empty IR would silently mute the stream (all-zero filter)
            raise ValueError("reverb IR is empty")
        self.device = resolve_device(device)
        self._hr, self._hi = _block_spectra_split(ir, partition, self.fft_size, self.device)
        j = int(self._hr.shape[0])
        bins = self.fft_size // 2 + 1
        self._ring_r = torch.zeros((j, bins), dtype=torch.float32, device=self.device)
        self._ring_i = torch.zeros((j, bins), dtype=torch.float32, device=self.device)
        self._overlap = torch.zeros(partition, dtype=torch.float32, device=self.device)

    def _step(self, ring_r, ring_i, seg, overlap):
        xr, xi = fft_ops.rfft_split(seg[None, :], self.fft_size)
        ring_r = torch.cat([xr, ring_r[:-1]], dim=0)
        ring_i = torch.cat([xi, ring_i[:-1]], dim=0)
        acc_r = torch.sum(ring_r * self._hr - ring_i * self._hi, dim=0)
        acc_i = torch.sum(ring_r * self._hi + ring_i * self._hr, dim=0)
        cr, ci = fft_ops.on_device(fft_ops._idft_matrices, self.fft_size, device=self.device)
        y = acc_r @ cr + acc_i @ ci
        return ring_r, ring_i, y[: self.part] + overlap, y[self.part :]

    def prime(self) -> None:
        """Run one step on silence without touching the delay line's state
        (a realtime caller warms the device up before the stream opens)."""
        seg = torch.zeros(self.fft_size, dtype=torch.float32, device=self.device)
        self._step(self._ring_r, self._ring_i, seg, self._overlap)[2].cpu()

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """Feed exactly one partition of samples (zero-pad the final one)."""
        if len(chunk) > self.part:
            raise ValueError(
                f"chunk of {len(chunk)} samples exceeds the partition "
                f"({self.part}); feed one partition per call"
            )
        seg = np.zeros(self.fft_size, dtype=np.float32)
        seg[: len(chunk)] = chunk
        rr, ri, out, ov = self._step(self._ring_r, self._ring_i,
                                     torch.from_numpy(seg).to(self.device), self._overlap)
        # the state stays on the device; only the audible block comes back
        self._ring_r, self._ring_i, self._overlap = rr, ri, ov
        return out.cpu().numpy()
