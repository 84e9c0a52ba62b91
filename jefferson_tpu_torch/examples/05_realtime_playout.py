"""Realtime playout on the card: the PortAudio-callback loop, block by
block.  (The port's copy of ``examples/05_realtime_playout.py``.)

A source orbits the listener while the AudioPlayout loop pulls one
128-sample block per callback (the reference's Audio.cu paCallback seam),
mixes, clip-checks, appends to a WAV, and records per-block compute time
against the 2.9 ms realtime deadline.  With the optional `sounddevice`
package and an output device, pass --live to hear it.

    python jefferson_tpu_torch/examples/05_realtime_playout.py [--device cpu] [--live]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.engine.stream import StreamingSpatializer
from jefferson_tpu_torch.io.wavio import StreamingWavWriter
from jefferson_tpu_torch.rt.playout import AudioPlayout, have_output_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--live", action="store_true", help="play through an audio device")
    args = p.parse_args(argv)

    cfg = jt.DEFAULT_CONFIG
    db = jt.synthetic_database(cfg)

    # two sources: a 440 Hz orbiter and a noise-burst source parked to the right
    t = np.arange(cfg.sample_rate) / cfg.sample_rate
    tone = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    rng = np.random.default_rng(0)
    bursts = (rng.standard_normal(cfg.sample_rate) * (rng.random(cfg.sample_rate) > 0.99) * 0.5)
    bursts = np.convolve(bursts, np.exp(-np.arange(128) / 24.0), mode="same").astype(np.float32)

    orbiter = StreamingSpatializer(db, cfg, device=args.device)
    orbiter.buf = tone
    parked = StreamingSpatializer(db, cfg, device=args.device)
    parked.buf = bursts
    parked.set_position(azi=90, ele=0, r=1.5)

    seconds = 3.0
    num_blocks = int(seconds / cfg.block_duration)
    state = {"b": 0}

    def orbit_source():
        b = state["b"]
        state["b"] += 1
        orbiter.set_position(azi=(b * 360.0 * cfg.block_duration / 2.0) % 360, ele=10, r=1.0)
        return orbiter.process_next()

    orbit_source.prime = orbiter.prime

    writer = StreamingWavWriter("live_mix.wav", cfg.sample_rate)
    play = AudioPlayout([orbit_source, parked], cfg, writer=writer)
    live = args.live and have_output_device()
    try:
        stats = play.play(num_blocks) if live else play.run_offline(num_blocks)
    finally:
        writer.close()
    print(f"{'live' if live else 'fake-device'} playout on {args.device} -> live_mix.wav")
    print(stats.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
