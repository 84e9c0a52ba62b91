"""Live interactive source control on the card, programmatically.  (The
port's copy of ``examples/07_live_control.py``.)

Three ways to move the source while audio renders (the reference's GLUT
interaction loop, reference: Jefferson/src/graphics.cu:487-601, headless):

1. In-process: SourceControl + AudioPlayout (shown here).
2. Terminal:   python -m jefferson_tpu_torch.rt -i in.wav --keys
3. Daemon:     {"cmd": "stream_start"} / {"cmd": "move"} / {"cmd": "stream_stop"}
               over the jefferson-torch-serve Unix socket.

    python jefferson_tpu_torch/examples/07_live_control.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.engine.stream import StreamingSpatializer
from jefferson_tpu_torch.rt.control import SourceControl, spherical_to_control_xyz
from jefferson_tpu_torch.rt.playout import AudioPlayout


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    cfg = jt.DEFAULT_CONFIG
    db = jt.synthetic_database(cfg)  # swap for load_hrtf(...) with real KEMAR data

    sr = cfg.sample_rate
    t = np.arange(2 * sr) / sr
    signal = (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)

    control = SourceControl()
    spat = StreamingSpatializer(db, cfg, device=args.device)
    fpb = cfg.frames_per_buffer
    state = {"i": 0, "b": 0}

    # a scripted "user": orbit by key presses, then jump via explicit moves
    script = {20: ["d"] * 3, 60: ["w", "w"], 100: ["up"], 140: ["r"]}

    def source():
        for key in script.get(state["b"], []):
            control.apply_key(key)
        if state["b"] == 180:  # programmatic spherical move (the daemon's 'move' form)
            control.move_to(*spherical_to_control_xyz(azi_deg=270, ele_deg=20, r=1.0))
        state["b"] += 1
        spat.set_position_cartesian(control.coordinates())
        idx = (np.arange(fpb) + state["i"]) % len(signal)
        state["i"] += fpb
        return spat.process_block(signal[idx])

    source.prime = spat.prime

    writer = jt.StreamingWavWriter("live_control.wav", sr)
    play = AudioPlayout([source], cfg, writer=writer)
    try:
        stats = play.run_offline(num_blocks=240, stop=lambda: control.quit)
    finally:
        writer.close()

    print(f"wrote live_control.wav on {args.device}: {stats.summary()}")
    print(f"crossfades fired: {spat.crossfades}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
