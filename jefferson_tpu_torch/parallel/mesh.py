"""Device meshes over ``torch.distributed``: one process (rank) per device.

Counterpart of ``jefferson_tpu/parallel/mesh.py``.  The JAX package has one
controller driving N devices through a ``jax.sharding.Mesh``; here the
program is SPMD: every rank runs the same script, holds the whole inputs,
computes its own shard, and the shards meet in explicit collectives.
Axis conventions are the JAX package's:

  * ``src``  — data-parallel over concurrent source streams
    (``BatchRenderer(mesh=...)``); the only collective is the mixdown's
    all-reduce, or the gather of each rank's rows when unmixed;
  * ``blk``  — parallel over the time blocks of one render
    (``Renderer(mesh=...)``); every rank holds the whole input, so a rank's
    overlap-save history is read from the fed stream and no halo moves.

Every collective of the port goes through ``mix_all_reduce`` and
``gather_rows``, which count their calls in ``collectives``.  On a gloo
group a CUDA tensor is copied to the host before the collective and the
result stays there (the renderers copy each chunk's output to the host in
any case); NCCL works on the card.

A world is started by ``init_world`` in each rank (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` from the environment, as ``torchrun`` sets them; a
process without them is a world of one), or by ``ensure_world``, which
re-executes the current script as n ranks on this host when it is not
already one of them.  The backend is explicit: NCCL for ``cuda`` and gloo
for ``cpu`` unless the caller names one; NCCL refuses two ranks on one
card, and so does ``init_world``, while gloo runs any number of ranks on
one card.
"""

from __future__ import annotations

import datetime
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

# calls of each collective since the last reset_collectives()
collectives = {"mix_all_reduce": 0, "gather_rows": 0}

# the environment a spawned rank is given; ensure_world replaces any
# inherited value of these rather than keeping it
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT")
# set in every rank this module spawns: the process is one rank of a world
SPAWNED = "JEFFERSON_TORCH_RANK"
# seconds a rank waits in a collective before its process group gives up
PG_TIMEOUT_S = 600.0
# seconds ensure_world waits for the ranks it spawned
WORLD_TIMEOUT_S = 3600.0

REPO_ROOT = Path(__file__).resolve().parents[2]


def reset_collectives() -> None:
    for name in collectives:
        collectives[name] = 0


def default_backend(device) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_size() -> int:
    """Ranks in the current process group; 1 outside one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def init_world(backend: str | None = None, *, device="cuda") -> torch.device:
    """Join the world this process's environment names and return the
    rank's device: ``cuda:(LOCAL_RANK % device_count)`` on the card (made
    the current device), the CPU otherwise.  A process without ``RANK`` and
    ``WORLD_SIZE`` starts a world of one on a free local port.  Under NCCL
    more ranks on a host than cards raises; gloo lets ranks share a card,
    each still running its kernels there.  Idempotent once joined (the
    backend must then be the world's)."""
    kind = torch.device(device).type
    backend = backend or default_backend(device)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: torch.cuda.is_available() is false; pass "
                               "device='cpu' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        local_rank = _env_int("LOCAL_RANK", _env_int("RANK", 0))
        local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"{local_world} ranks on this host would share {cards} card(s): NCCL refuses "
                f"two ranks on one card; pass backend='gloo' to run them on shared cards")
        rank_device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(rank_device)
    else:
        rank_device = torch.device("cpu")
        # ranks on one host split its cores rather than each taking all
        local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // local_world)))
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"this process's world runs {dist.get_backend()}, not {backend}")
        return rank_device
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1, timeout=timeout)
    return rank_device


def free_port() -> int:
    """A local port that was free a moment ago (the rendezvous binds it
    later, so a lost race is possible and surfaces as a failed start)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(env: dict, rank: int, world: int, port: int, local_world: int | None = None) -> dict:
    """``env`` with the rank variables of ``rank`` in a ``world`` on this
    host REPLACED (an inherited count must not win), the repository root
    first on PYTHONPATH (the package is not installed) and the output
    unbuffered (a killed rank's log stays whole)."""
    local_world = world if local_world is None else local_world
    out = {k: v for k, v in env.items() if k not in RANK_ENV}
    out.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
               LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), PYTHONUNBUFFERED="1")
    out[SPAWNED] = "1"
    existing = out.get("PYTHONPATH", "")
    out["PYTHONPATH"] = str(REPO_ROOT) + (os.pathsep + existing if existing else "")
    return out


def spawn(cmds: list[list[str]], envs: list[dict], timeout: float,
          capture: bool = True) -> tuple[list, list[str] | None]:
    """Run one process per command, all at once, and wait for all of them
    against one deadline -> (failures [(rank, code or "timeout")], each
    rank's output when ``capture``).  The first rank to exit non-zero ends
    the group: the others would wait on it in a collective, so they are
    killed.  Captured output goes to unbuffered temporary files (never a
    pipe that a long traceback could fill), read in binary and decoded with
    replacement (a killed rank can stop mid-character)."""
    logs = [tempfile.TemporaryFile(mode="w+b") for _ in cmds] if capture else None
    procs = [subprocess.Popen(cmd, env=env, stdout=logs[i] if capture else None,
                              stderr=subprocess.STDOUT if capture else None)
             for i, (cmd, env) in enumerate(zip(cmds, envs))]
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c is not None for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [(i, "timeout") for i, c in enumerate(codes) if c is None]
                break
            time.sleep(0.1)
    finally:
        for p in procs:  # survivors of a failure, or of an interrupt
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = None
    if capture:
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read().decode("utf-8", errors="replace"))
            log.close()
    return failed, outs


def worst_code(failed) -> int:
    """The exit code a group's failures give: the first failed rank's own
    code, 124 for a group that ran out of time, 0 for none."""
    if not failed:
        return 0
    code = failed[0][1]
    return 124 if code == "timeout" else (code if code > 0 else 1)


def reexec_command() -> list[str]:
    """This script's command line, ``python -m pkg.mod`` kept as such (under
    -m, sys.argv[0] is the module's file, and running it as a plain script
    would lose its package)."""
    import __main__

    spec = getattr(__main__, "__spec__", None)
    if spec is not None and spec.name:
        return [sys.executable, "-m", spec.name] + sys.argv[1:]
    return [sys.executable] + sys.argv


def ensure_world(n: int, *, backend: str | None = None, device="cuda") -> torch.device:
    """Make sure this process is a rank of a world of at least n ranks and
    return its device (``init_world``).

    Call it at the top of a script.  Three cases:
      * already a rank (a world is joined, or this process was spawned as a
        rank, or ``torchrun`` started it): join the world if need be and
        return; a world of fewer than n ranks raises;
      * otherwise re-execute ``sys.argv`` as n ranks on a local rendezvous
        (each rank runs this call again and returns from it), wait for them
        and exit with the group's code (``worst_code``).
    Under NCCL on the card the n ranks need n cards: fewer raises
    ``requested n devices, have m``, as ``make_mesh`` does in the JAX
    package.  ``backend="gloo"`` runs them on the cards there are."""
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda" and backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
    in_world = (dist.is_initialized() or os.environ.get(SPAWNED) == "1"
                or "TORCHELASTIC_RUN_ID" in os.environ)
    if in_world:
        rank_device = init_world(backend, device=device)
        if dist.get_world_size() < n:
            raise ValueError(f"requested {n} devices, have {dist.get_world_size()}")
        return rank_device
    port = free_port()
    print(f"[jefferson_tpu_torch] not a rank of a {n}-rank world: re-exec as {n} ranks "
          f"({backend}, {torch.device(device).type}) on 127.0.0.1:{port}", file=sys.stderr)
    cmd = reexec_command()
    failed, _ = spawn([cmd] * n, [rank_env(os.environ, r, n, port) for r in range(n)],
                      WORLD_TIMEOUT_S, capture=False)
    if failed:
        print(f"[jefferson_tpu_torch] ranks failed: {failed}", file=sys.stderr)
    sys.exit(worst_code(failed))


def mesh_shape(n: int, ndim: int) -> tuple[int, ...]:
    """The JAX package's mesh shape: (n,), or the near-square 2-D
    factorization (6 -> 2x3, 8 -> 2x4, a prime p -> 1xp)."""
    if ndim == 1:
        return (n,)
    a = math.isqrt(n)
    while n % a:
        a -= 1
    return (a, n // a)


def make_mesh(n_devices: int | None = None, axis_names: tuple[str, ...] = ("src",), *,
              device="cuda"):
    """A ``DeviceMesh`` over the first n ranks of the world (default: all),
    1-D, or 2-D with the near-square factorization; ``device`` names the
    mesh's device type.  Every rank of the world calls it (the mesh's
    process groups are made collectively); a rank past the first n is not
    in the mesh and renders nothing on it."""
    from torch.distributed.device_mesh import DeviceMesh

    have = world_size()
    n = have if n_devices is None else n_devices
    if n < 1:
        # 0 does not mean "all", nor a negative count "all but some"
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if len(axis_names) not in (1, 2):
        raise ValueError("only 1-D or 2-D meshes supported")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a world: init_world() or ensure_world(n) first")
    ranks = torch.arange(n).reshape(mesh_shape(n, len(axis_names)))
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=tuple(axis_names))


def check_mesh(mesh):
    """``mesh`` when it is a DeviceMesh, else a TypeError."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (parallel.mesh.make_mesh), "
                        f"got {type(mesh).__name__}")
    return mesh


def in_mesh(mesh) -> bool:
    """Whether this rank renders on ``mesh``: a world can hold more ranks
    than a mesh over its first n (None, no mesh: every process renders)."""
    return mesh is None or mesh.get_coordinate() is not None


def mesh_position(mesh) -> int:
    """This rank's place in the mesh, host-major over both axes of a 2-D
    mesh; a rank outside the mesh raises."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"this rank is not in the mesh of ranks {mesh.mesh.tolist()}")
    pos = 0
    for c, size in zip(coord, mesh.mesh.shape):
        pos = pos * size + c
    return pos


def _contiguous(mesh, count: int, what: str) -> tuple[int, int]:
    n = mesh.size()
    if count % n:
        raise ValueError(f"{count} {what} do not divide over the {n}-device mesh")
    per = count // n
    lo = mesh_position(mesh) * per
    return lo, lo + per


def source_range(mesh, s: int) -> tuple[int, int]:
    """This rank's contiguous sources [lo, hi) of s, host-major over both
    axes of a 2-D mesh (the JAX multihost worker's slicing)."""
    return _contiguous(mesh, s, "sources")


def block_range(mesh, nb: int) -> tuple[int, int]:
    """This rank's contiguous blocks [lo, hi) of nb, as source_range."""
    return _contiguous(mesh, nb, "blocks")


def _groups(mesh, dim: str | None):
    """The process groups a collective crosses, innermost mesh axis first
    (host-major order over a 2-D mesh)."""
    if dim is not None:
        return [mesh.get_group(dim)]
    return [mesh.get_group(d) for d in reversed(range(mesh.ndim))]


def _on_backend(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend takes it: a CUDA tensor is copied to
    the host for gloo, and stays there."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.cpu()
    return t.contiguous()


def mix_all_reduce(t: torch.Tensor, mesh, dim: str | None = None) -> torch.Tensor:
    """The mixdown: each rank's partial sum ``t`` summed over the mesh (one
    mesh axis with ``dim``) -> the sum, on every rank."""
    collectives["mix_all_reduce"] += 1
    for group in _groups(mesh, dim):
        t = _on_backend(t, group).clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_rows(t: torch.Tensor, mesh, dim: str | None = None) -> torch.Tensor:
    """Each rank's equal block of rows ``t`` (its sources or blocks, along
    dim 0) -> the rows of every rank in mesh order, on every rank."""
    collectives["gather_rows"] += 1
    for group in _groups(mesh, dim):
        t = _on_backend(t, group)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts)
    return t
