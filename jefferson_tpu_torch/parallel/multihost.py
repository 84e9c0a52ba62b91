"""Multi-process (multi-host-shaped) mesh validation on torch.distributed.

Counterpart of ``jefferson_tpu/parallel/multihost.py``.  The claim it makes
executable: independent sources shard over any mesh with the mixdown as the
only collective, including a 2-D ('host', 'chip') mesh whose source axis
crosses a process boundary.  ``run_multiprocess_dryrun`` spawns
``num_processes x local_devices`` ranks, one per device (the port is SPMD:
a process per device where the JAX package has a process per host), builds
the ('host', 'chip') mesh, and runs ONE full batched render step with

  * the sources sharded host-major over both mesh axes,
  * the mixdown all-reduced across the processes (``mesh.mix_all_reduce``),
  * rank 0 checking the mix, and its own rows row for row (the mix is
    blind to a source placed on the wrong rank), against an unsharded
    render of the same inputs through the same chunk function.

The per-rank worker is this module's ``__main__``.  It takes either
``--process-id/--num-processes/--local-devices/--coordinator`` (the JAX
worker's flags; here the process id is the rank) or the environment
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), so it is the
template for a real multi-node launch: on each of k hosts with g cards,

    torchrun --nnodes k --nproc-per-node g --rdzv-endpoint host0:PORT \\
        -m jefferson_tpu_torch.parallel.multihost

and each host's cards form the 'chip' axis.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import mesh as pm

WORKER = "jefferson_tpu_torch.parallel.multihost"


def run_multiprocess_dryrun(num_processes: int = 2, local_devices: int = 4,
                            timeout: float = 600.0, *, device="cuda",
                            backend: str | None = None) -> None:
    """Spawn the ranks of ``num_processes`` hosts x ``local_devices``
    devices, wait for them against one deadline, and raise if any fails (a
    dead rank fails the group at once).  The rendezvous port is picked
    free-then-released (rank 0 binds it seconds later), so a run that times
    out is retried once on a fresh port."""
    try:
        _run_once(num_processes, local_devices, timeout, device, backend)
    except RuntimeError as e:
        if "timeout" not in str(e):
            raise
        _run_once(num_processes, local_devices, timeout, device, backend)


def _run_once(num_processes: int, local_devices: int, timeout: float, device,
              backend: str | None) -> None:
    world = num_processes * local_devices
    port = pm.free_port()
    backend = backend or pm.default_backend(device)
    cmds = [[sys.executable, "-m", WORKER, "--process-id", str(r), "--num-processes", str(world),
             "--local-devices", str(local_devices), "--coordinator", f"127.0.0.1:{port}",
             "--device", torch.device(device).type, "--backend", backend]
            for r in range(world)]
    envs = [pm.rank_env(os.environ, r, world, port, local_devices) for r in range(world)]
    failed, outs = pm.spawn(cmds, envs, timeout)
    if failed:
        raise RuntimeError(f"multi-process dryrun failed: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{out}" for r, out in enumerate(outs)))
    for out in outs:
        for line in out.splitlines():
            if line.startswith("[multihost"):
                print(line)


def _inputs(s: int, nb: int):
    """The same global inputs on every rank: s orbiting sources x nb blocks."""
    from ..config import DEFAULT_CONFIG
    from ..engine.plan import make_plan
    from ..hrtf.kemar import synthetic_database
    from ..trajectory.trajectory import CircularOrbit

    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    rng = np.random.default_rng(0)
    feds = (rng.standard_normal((s, nb * cfg.frames_per_buffer)) * 0.2).astype(np.float32)
    plans = [make_plan(CircularOrbit(period_s=0.5 + 0.1 * i, ele=5, r=1.0).sample(nb, cfg), cfg)
             for i in range(s)]
    stack = lambda attr: np.stack([getattr(p, attr) for p in plans])
    rest = [feds, *(stack(a) for a in ("idx_new", "w_new", "idx_old", "w_old", "xfade", "u_hi",
                                       "u_lo", "inv_frac"))]
    return cfg, db, np.zeros((s, cfg.history_len), np.float32), rest


def _worker(rank_device: torch.device, local_devices: int) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..convert import spectra_from_numpy
    from ..engine.batch import batched_chunk_fn, mix_sources

    world, rank = dist.get_world_size(), dist.get_rank()
    # hard errors, not asserts: the gates must hold under python -O (the
    # worker is also a real launch's template)
    if world % local_devices:
        raise RuntimeError(f"{world} ranks do not form hosts of {local_devices} devices")
    mesh = DeviceMesh(rank_device.type, torch.arange(world).reshape(world // local_devices,
                                                                    local_devices),
                      mesh_dim_names=("host", "chip"))
    s, nb = 2 * world, 8
    cfg, db, hists, rest = _inputs(s, nb)
    lo, hi = pm.source_range(mesh, s)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(rank_device)
    spectra = spectra_from_numpy(db.spectra, rank_device)
    step = batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True)
    pm.reset_collectives()
    outs, new_hists = step(spectra, put(hists[lo:hi]), *(put(a[lo:hi]) for a in rest))
    mixed = pm.mix_all_reduce(mix_sources(outs), mesh).cpu().numpy()
    counts = dict(pm.collectives)
    fpb = cfg.frames_per_buffer
    if tuple(outs.shape) != (hi - lo, nb, fpb, 2):
        raise RuntimeError(f"sharded outs shape {tuple(outs.shape)}")
    if tuple(new_hists.shape) != (hi - lo, cfg.history_len):
        raise RuntimeError(f"sharded new_hists shape {tuple(new_hists.shape)}")
    if mixed.shape != (nb, fpb, 2):
        raise RuntimeError(f"mixdown shape {mixed.shape}")
    if not np.isfinite(mixed).all():
        raise RuntimeError("non-finite values in the cross-process mixdown")
    if counts != {"mix_all_reduce": 1, "gather_rows": 0}:
        raise RuntimeError(f"collectives {counts}, want one mixdown")
    if rank == 0:
        # the cross-process mixdown against an unsharded render of the same
        # inputs through the same chunk function
        ref, _ = step(spectra, put(hists), *(put(a) for a in rest))
        d = float(np.abs(mixed - mix_sources(ref).cpu().numpy()).max())
        if d >= 1e-5:
            raise RuntimeError(f"multi-process mixdown mismatch: {d}")
        # ORDER-SENSITIVE: the mix cannot see a source placed on the wrong
        # rank, so this rank's rows are held row for row
        d_rows = float(np.abs(outs.cpu().numpy() - ref[lo:hi].cpu().numpy()).max())
        if d_rows >= 1e-5:
            raise RuntimeError(f"source-placement mismatch on rank 0's shard: {d_rows}")
        print(f"[multihost] {world // local_devices} processes x {local_devices} devices "
              f"({world} ranks, {dist.get_backend()} on {rank_device.type}): {s} src over "
              f"('host','chip') mesh {list(mesh.mesh.shape)}, cross-process all-reduce "
              f"mixdown max|diff| vs unsharded = {d:.2e}, per-source shard rows = "
              f"{d_rows:.2e}, collectives {counts} OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, default=None,
                    help="this rank (default: $RANK, as torchrun sets it)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="ranks in the world (default: $WORLD_SIZE)")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="ranks per host, the 'chip' axis (default: $LOCAL_WORLD_SIZE)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous (default: $MASTER_ADDR:$MASTER_PORT)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", default=None, help="nccl (the card's default) or gloo")
    args = ap.parse_args(argv)
    if args.process_id is not None:
        if args.num_processes is None or args.coordinator is None:
            ap.error("--process-id needs --num-processes and --coordinator")
        local = args.local_devices or args.num_processes
        addr, _, port = args.coordinator.rpartition(":")
        os.environ.update(RANK=str(args.process_id), WORLD_SIZE=str(args.num_processes),
                          LOCAL_RANK=str(args.process_id % local), LOCAL_WORLD_SIZE=str(local),
                          MASTER_ADDR=addr, MASTER_PORT=port)
    local = args.local_devices or int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    rank_device = pm.init_world(args.backend, device=args.device)
    try:
        _worker(rank_device, local)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
