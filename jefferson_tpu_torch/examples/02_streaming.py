"""Live streaming on the card: push 128-sample blocks, steer the source in
real time.  (The port's copy of ``examples/02_streaming.py``.)

This is the PortAudio-callback analogue: wire ``process_block`` into any
audio callback.

    python jefferson_tpu_torch/examples/02_streaming.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.engine.stream import StreamingSpatializer
from jefferson_tpu_torch.utils.profiling import RTFMeter


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    cfg = jt.DEFAULT_CONFIG
    db = jt.synthetic_database(cfg)
    sp = StreamingSpatializer(db, cfg, device=args.device)
    sp.buf = (np.random.default_rng(0).standard_normal(cfg.sample_rate) * 0.1).astype(np.float32)
    sp.prime()  # build the kernels and warm the step before the first block

    meter = RTFMeter(cfg.sample_rate, cfg.frames_per_buffer)
    outs = []
    for k in range(200):  # ~0.6 s of audio
        sp.set_position(azi=(k * 2) % 360, ele=10, r=1.0)  # steer per block
        with meter.measure():
            outs.append(sp.process_next())
    meter.report(f"streaming on {args.device}")
    if sp.clipping:
        print("ALERT! CLIPPING AUDIO!")
    jt.write_wav("stream.wav", np.concatenate(outs), cfg.sample_rate)
    print("wrote stream.wav")
    return 0


if __name__ == "__main__":
    sys.exit(main())
