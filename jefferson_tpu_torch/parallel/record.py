"""One rank's record of a piece of work on a mesh: what it cost and what it
gave, in the same keys wherever ranks are compared.

The daemon's ranks (``serve.py``), the mesh tests' worker
(``tests/test_torch_parallel.py``) and ``chip_smoke.py``'s phase mesh each
run work on every rank and hold the ranks' records side by side: the wall,
the collectives (``parallel.mesh.collectives``) and kernel launches
(``kernels.fused_step.launches``, launch A's in ``forward``) the work made,
counted as differences so that nothing is reset, and a digest of what it
returned.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from . import mesh


def rank() -> int:
    """This process's rank; 0 outside a world."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def digest(a) -> str:
    """The sha256 of an array's bytes (a tensor's on the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _counts():
    from ..kernels import fused_step

    return (dict(mesh.collectives), dict(fused_step.launches),
            sum(fused_step.forward_launches.values()))


def recorded(fn, device=None):
    """Run ``fn()`` on this rank -> (its result, the rank's record): ``rank``,
    ``wall_s`` (on a CUDA ``device`` the card is synchronised before and
    after, so the wall holds the work's device time), and the
    ``collectives``, ``launches`` (kernels launched, by name) and
    ``forward`` (launch A's) that the call made.  An exception propagates."""
    cuda = device is not None and torch.device(device).type == "cuda"
    col0, launch0, fwd0 = _counts()
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    col1, launch1, fwd1 = _counts()
    return out, {
        "rank": rank(), "wall_s": wall,
        "collectives": {k: v - col0[k] for k, v in col1.items()},
        "launches": {k: v - launch0[k] for k, v in launch1.items() if v != launch0[k]},
        "forward": fwd1 - fwd0,
    }
