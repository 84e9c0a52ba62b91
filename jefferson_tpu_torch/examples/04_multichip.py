"""Multi-device scaling: shard 16 concurrent sources over a device mesh.
(The port's copy of ``examples/04_multichip.py``.)

The port is SPMD: one process (rank) per device, ``torch.distributed``
between them.  ``ensure_world(8)`` re-executes this script as 8 ranks when
it is not one already; every rank renders its 2 sources and the mixdown's
all-reduce gives each rank the whole mix.  The ranks run on the CPU by
default (the JAX example's virtual CPU mesh); ``--device cuda`` takes one
card per rank over NCCL, and ``--backend gloo`` lets the ranks share cards.

The same mesh is reachable from the CLI: ``python -m
jefferson_tpu_torch.cli.main --scene scene.json --devices N`` shards the
source axis exactly like this example, and ``-i in.wav --devices N``
shards one render's time blocks instead (each rank reads its overlap-save
history from the input, so no halo moves between ranks).

    python jefferson_tpu_torch/examples/04_multichip.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np
import torch.distributed as dist

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.parallel.mesh import collectives, ensure_world, make_mesh
from jefferson_tpu_torch.trajectory.trajectory import CircularOrbit, StaticPosition

RANKS = 8


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cpu")
    p.add_argument("--backend", default=None, help="nccl (the card's default) or gloo")
    args = p.parse_args(argv)
    device = ensure_world(RANKS, device=args.device, backend=args.backend)

    cfg = jt.DEFAULT_CONFIG
    db = jt.synthetic_database(cfg)
    n_dev = dist.get_world_size()
    s, blocks = 2 * n_dev, 32
    rng = np.random.default_rng(0)
    signals = (rng.standard_normal((s, blocks * cfg.frames_per_buffer)) * 0.1).astype(np.float32)
    positions = np.stack([
        CircularOrbit(period_s=0.5 + 0.1 * i, ele=5, r=1.0).sample(blocks, cfg) if i % 2
        else StaticPosition(azi=20 * i, ele=0, r=1.0).sample(blocks, cfg)
        for i in range(s)
    ])
    mesh = make_mesh(n_dev, device=args.device)
    br = BatchRenderer(db, cfg, device=device, chunk_blocks=blocks, mesh=mesh, mix=True)
    mix = br.render(signals, positions)
    if dist.get_rank() == 0:
        print(f"mixed {s} sources sharded over {n_dev} ranks ({dist.get_backend()}, "
              f"{device.type}): {mix.shape}, peak {np.abs(mix).max():.3f}, arms "
              f"{sorted(set(br.dispatch))}, collectives {collectives}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
