"""Precision checking for the port's scripts and gates: a copy of
``jefferson_tpu/testing.py`` (``PrecisionReport``, ``precision_check`` and
``rms_error``), pinned to the original by ``tests/test_torch_probes.py`` and
``tests/test_torch_trajectory.py``.

``precisionChecking`` of the reference (Jefferson/src/functions.cpp:41-70):
the first and the worst absolute mismatch between two buffers against an
absolute epsilon; the end-to-end WAV gate uses 2e-7
(Jefferson/Precision_Check.py:12).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PrecisionReport:
    ok: bool
    max_abs_diff: float
    max_index: int
    first_bad_index: int
    rms: float
    eps: float

    def __bool__(self) -> bool:
        return self.ok

    def __str__(self) -> str:
        s = "OK" if self.ok else "MISMATCH"
        return (
            f"{s}: max|diff|={self.max_abs_diff:.3e} @ {self.max_index}, "
            f"rms={self.rms:.3e}, eps={self.eps:.1e}, first_bad={self.first_bad_index}"
        )


def precision_check(a, b, eps: float = 1e-8) -> PrecisionReport:
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    max_idx = int(np.argmax(d)) if d.size else 0
    bad = d > eps
    first_bad = int(np.argmax(bad)) if bad.any() else -1
    rms = float(np.sqrt(np.mean(d * d))) if d.size else 0.0
    return PrecisionReport(
        ok=not bad.any(),
        max_abs_diff=float(d[max_idx]) if d.size else 0.0,
        max_index=max_idx,
        first_bad_index=first_bad,
        rms=rms,
        eps=eps,
    )


def rms_error(a, b) -> float:
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    return float(np.sqrt(np.mean((a - b) ** 2)))
