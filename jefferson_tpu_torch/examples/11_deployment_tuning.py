"""Deployment tuning on the card: the offline-render levers and when to
pull them.  (The port's copy of ``examples/11_deployment_tuning.py``.)

Every lever here is BIT-IDENTICAL to the defaults (same arithmetic, same
outputs); they trade the launch and transfer schedule, not audio:

  * ``pipeline_fetch=True``: fetch each chunk's output one chunk late,
    after the next chunk is launched (a side CUDA stream into pinned host
    slots), so the copy overlaps the next chunk's work.
  * explicit ``chunk_blocks``: a daemon serving varied durations keeps one
    chunk shape; interactive tools keep the automatic sizing (hold scenes
    take larger chunks, movers stay at the fused step's 256).
  * a device mesh: ``Renderer(mesh=make_mesh(n, ("blk",)))`` shards one
    render's blocks over n ranks, ``BatchRenderer(mesh=make_mesh(n))`` a
    scene's sources (``jefferson_tpu_torch.parallel.mesh``; examples 04
    and 09, the CLI's ``--devices``).

    python jefferson_tpu_torch/examples/11_deployment_tuning.py [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.trajectory.trajectory import AzimuthSweep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    cfg = jt.DEFAULT_CONFIG
    db = jt.synthetic_database(cfg)
    sr = cfg.sample_rate
    sig = (0.3 * np.sin(2 * np.pi * 220 * np.arange(2 * sr) / sr)).astype(np.float32)
    blocks = len(sig) // cfg.frames_per_buffer
    # the reference benchmark cadence: positions hold for 172 blocks per step
    positions = AzimuthSweep(
        start_azi=0, ele=0, r=0.5, step_deg=5.0, blocks_per_step=172,
        num_steps=blocks // 172 + 1,
    ).sample(blocks, cfg)

    base = Renderer(db, cfg, device=args.device, chunk_blocks=256)
    tuned = Renderer(db, cfg, device=args.device, chunk_blocks=256, pipeline_fetch=True)

    t0 = time.time()
    want = base.render(sig, positions)
    t_base = time.time() - t0
    t0 = time.time()
    got = tuned.render(sig, positions)
    t_tuned = time.time() - t0

    if not np.array_equal(got, want):
        raise SystemExit("the levers changed a sample")
    print(f"{blocks} blocks on {args.device}: sync {t_base*1e3:.0f} ms, pipelined "
          f"{t_tuned*1e3:.0f} ms (bit-identical; the first render includes the "
          f"kernels' build and the first uploads)")
    print("deployment notes: a daemon -> pin chunk_blocks; a host-bound render -> "
          "pipeline_fetch=True; several cards -> a mesh of ranks (--devices N, example 04)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
