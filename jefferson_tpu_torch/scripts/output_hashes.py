"""The sha256 of every main-path output at one geometry, on the card: a
change that must keep the bits (a kernel made to take more geometries, a
refactor) runs this on the parent's checkout and on its own in one call,
and the two JSON lines must be equal.

    python jefferson_tpu_torch/scripts/output_hashes.py [--fpb 128] [--taps 512]

Run it as a file, with the checkout to hash first on PYTHONPATH: it
imports ``jefferson_tpu_torch`` from there.  The outputs: ``Renderer`` on
a sweep, an orbit, the helix and a new random position every block (the
dedup+fused, one-hot and gather arms, also without the crossfade), each
with and without ``fused``; ``BatchRenderer`` on a hold scene, a mover
scene and wide movers (16 sources); ``render_scan`` on the orbit; 300
live blocks of ``StreamingSpatializer``; and the bench step (row 1).  At a
history of partial blocks (fpb 441) the scenes and the bench step, which
need whole blocks, are left out.  Each with the launches it made by kernel
and launch A's by form.  Inputs come from a seed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fpb", type=int, default=128)
    p.add_argument("--taps", type=int, default=512)
    p.add_argument("--blocks", type=int, default=3000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.config import EngineConfig
    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.engine.stream import StreamingSpatializer, render_scan
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database
    from jefferson_tpu_torch.kernels import fused_step as fs
    from jefferson_tpu_torch.trajectory.trajectory import AzimuthSweep, CircularOrbit

    cfg = EngineConfig(frames_per_buffer=args.fpb, hrtf_len=args.taps)
    db = synthetic_database(cfg)
    fpb, n = cfg.frames_per_buffer, args.blocks
    sig = (np.random.default_rng(0).standard_normal(n * fpb) * 0.2).astype(np.float32)
    single = {
        "sweep": AzimuthSweep(start_azi=3.0, ele=5.0, r=0.5, blocks_per_step=172,
                              num_steps=72).sample(n, cfg),
        "orbit": CircularOrbit(period_s=0.4, ele=5, r=1.0).sample(n, cfg),
        "helix": bench.helix_positions(n, cfg=cfg),
        "wide": bench.wide_positions(1, n)[0],
    }
    out = {}

    def record(name, fn):
        fs.reset_launches()
        got = np.ascontiguousarray(fn())
        out[name] = {"sha256": hashlib.sha256(got.tobytes()).hexdigest(),
                     "launches": {k: v for k, v in fs.launches.items() if v},
                     "forward": {k: v for k, v in fs.forward_launches.items() if v}}

    for what, pos in single.items():
        for fused in (True, False):
            r = Renderer(db, device=args.device, chunk_blocks=1024, fused=fused)
            record(f"Renderer {what}{'' if fused else ' unfused'}", lambda: r.render(sig, pos))
    whole = cfg.pad_len % fpb == 0
    s, nb = 16, n // 4
    sigs = bench.scene_signals(sig, s, nb, fpb)
    for what, pos in (("hold", bench.scene_hold_positions(s, nb, 172)),
                      ("movers", bench.scene_mover_positions(s, nb)),
                      ("wide", bench.wide_positions(s, nb))) if whole else ():
        r = BatchRenderer(db, device=args.device, chunk_blocks=256)
        record(f"BatchRenderer {what}", lambda: r.render(sigs, pos))
    record("render_scan orbit",
           lambda: render_scan(sig, db, single["orbit"], cfg, device=args.device))

    def live():
        sp = StreamingSpatializer(db, device=args.device)
        blocks = []
        for i in range(300):
            if i % 3 == 0:
                sp.set_position(azi=7.0 * i % 360, ele=5.0, r=1.0)
            blocks.append(sp.process_block(sig[i * fpb:(i + 1) * fpb]))
        return np.concatenate(blocks)

    record("live 300 blocks", live)
    if whole:
        wl = bench.build_workload(db, 16, 64, torch.device(args.device))
        record("bench step", lambda: bench.run_step(wl)[0].cpu().numpy())
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
