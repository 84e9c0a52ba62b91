"""PyTorch / CUDA port of jefferson_tpu for one NVIDIA H100.

The JAX package ``jefferson_tpu`` stays the reference; this package mirrors
its module names (``config``, ``hrtf``, ``trajectory``, ``oracle``, ``ops``,
``engine``, and ``kernels`` for ``pallas``) so each counterpart is easy to
find.  It imports ``torch`` and never ``jax``, and nothing of
``jefferson_tpu``: it keeps its own copies of the host code it uses, each
pinned to its original by a test.

Every entry point (``Renderer``, ``BatchRenderer``, ``StreamingSpatializer``,
``render_scan``, ``DifferentiableRenderer``, ``fit_database``) runs on the
card unless the caller passes ``device="cpu"``; a CUDA device without a
card raises, and nothing falls back to another device.  The engine is
float32 end to
end and never TF32 — the distance ramp's 12-bit phase split
(``ops/filters.distance_phase_split``) and the 1e-6 oracle gate need full
fp32 products, so both TF32 switches are turned off on import.

The top-level names are those of ``jefferson_tpu/__init__.py`` that the
port has; the renderers, the oracle, the SOFA loader and the
differentiable path resolve lazily.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# MKL's vector math (torch.cos and torch.sin on the CPU) sets itself up on
# its first call.  Made first by several threads at once (a tensor torch
# splits over them), that call returned now and then some cosines off the
# ones every later call returns (scripts/first_step.py).  One call on one
# thread, here, sets it up before any other.
torch.cos(torch.zeros(16))

from .config import DEFAULT_CONFIG, EngineConfig, ProcessType  # noqa: E402
from .hrtf.kemar import (  # noqa: E402
    HRTFDatabase,
    load_compact,
    load_database,
    load_full,
    pick_hrtf,
    synthetic_database,
)
from .io.wavio import StreamingWavWriter, read_wav, read_wav_mono, write_wav  # noqa: E402
from .testing import precision_check, rms_error  # noqa: E402

__version__ = "0.2.0"

_LAZY = {
    "Renderer": "jefferson_tpu_torch.engine.renderer",
    "BatchRenderer": "jefferson_tpu_torch.engine.batch",
    "StreamingSpatializer": "jefferson_tpu_torch.engine.stream",
    "AudioPlayout": "jefferson_tpu_torch.rt.playout",
    "render_oracle": "jefferson_tpu_torch.oracle.reference",
    "load_sofa": "jefferson_tpu_torch.hrtf.sofa",
    "DifferentiableRenderer": "jefferson_tpu_torch.diff.render",
    "fit_database": "jefferson_tpu_torch.diff.personalize",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


__all__ = [
    *_LAZY,
    "DEFAULT_CONFIG",
    "EngineConfig",
    "ProcessType",
    "HRTFDatabase",
    "load_compact",
    "load_database",
    "load_full",
    "pick_hrtf",
    "synthetic_database",
    "StreamingWavWriter",
    "read_wav",
    "read_wav_mono",
    "write_wav",
    "precision_check",
    "rms_error",
]
