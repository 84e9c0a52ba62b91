"""Multi-host-shaped scaling: sources sharded across PROCESSES.
(The port's copy of ``examples/09_multihost.py``.)

Sources are embarrassingly parallel, so the mesh that shards them over one
host's devices (example 04) extends across hosts: a 2-D ('host', 'chip')
mesh whose source axis crosses the process boundary, the mixdown's
all-reduce the only collective riding the inter-host link.

This example runs the executable local validation: 2 hosts x 2 devices as
4 ranks on ``torch.distributed``, one full batched render step, the
cross-process mixdown and rank 0's own rows checked against an unsharded
render (the graft dryrun's stage (f)).  The ranks run on the CPU by
default; ``--device cuda --backend gloo`` runs them on the card(s).

On a real cluster the per-rank worker is the template; on each host:

    torchrun --nnodes K --nproc-per-node G --rdzv-endpoint host0:PORT \\
        -m jefferson_tpu_torch.parallel.multihost

    python jefferson_tpu_torch/examples/09_multihost.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

from jefferson_tpu_torch.parallel.multihost import run_multiprocess_dryrun


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cpu")
    p.add_argument("--backend", default=None, help="nccl (the card's default) or gloo")
    args = p.parse_args(argv)
    run_multiprocess_dryrun(num_processes=2, local_devices=2, device=args.device,
                            backend=args.backend)
    print("multi-process mesh render verified (see [multihost] line above)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
