"""PyTorch / CUDA port of jefferson_tpu for one NVIDIA H100.

The JAX package ``jefferson_tpu`` stays the reference; this package mirrors
its module names (``config``, ``hrtf``, ``trajectory``, ``oracle``, ``ops``,
``engine``, and ``kernels`` for ``pallas``) so each counterpart is easy to
find.  It imports ``torch`` and never ``jax``, and nothing of
``jefferson_tpu``: it keeps its own copies of the host code it uses, each
pinned to its original by a test.

Every entry point (``Renderer``, ``BatchRenderer``, ``StreamingSpatializer``,
``render_scan``) runs on the card unless the caller passes ``device="cpu"``;
a CUDA device without a card raises, and nothing falls back to another
device.  The engine is float32 end to
end and never TF32 — the distance ramp's 12-bit phase split
(``ops/filters.distance_phase_split``) and the 1e-6 oracle gate need full
fp32 products, so both TF32 switches are turned off on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
