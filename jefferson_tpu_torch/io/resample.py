"""Sample-rate conversion for inputs not at the engine rate: a copy of
``jefferson_tpu/io/resample.py`` on scipy, pinned to the original by
``tests/test_torch_cli.py``.

The reference ignores the input file's sample rate entirely — a 22.05 kHz
file plays pitch-shifted through the 44.1 kHz engine (readFile never checks
it, reference: Jefferson/src/cudaPart.cu:21-63).  Here wrong-rate inputs are
polyphase-resampled to the engine rate by default (CLI --no-resample
restores the reference's raw behavior).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import scipy.signal


def read_wav_mono_at(path, sample_rate: int) -> np.ndarray:
    """Read a WAV, downmix to mono, resample to ``sample_rate`` if the
    file's rate differs: the load policy of the realtime loop and the
    serving daemon (the offline CLI keeps its own --no-resample variant)."""
    from .wavio import read_wav_mono

    sig, sr = read_wav_mono(path)
    if sr != sample_rate:
        sig = resample(sig, sr, sample_rate)
    return sig


def resample(signal: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample float32 audio from sr_in to sr_out along the last
    axis (1-D signals, or batches of rows — one filter design either way)."""
    if sr_in == sr_out:
        return np.asarray(signal, dtype=np.float32)
    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    out = scipy.signal.resample_poly(
        np.asarray(signal, dtype=np.float64), frac.numerator, frac.denominator,
        axis=-1,
    )
    return out.astype(np.float32)
