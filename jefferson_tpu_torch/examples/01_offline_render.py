"""Offline render on the card: orbiting source, distance cues, WAV + scene
views out.  (The port's copy of ``examples/01_offline_render.py``.)

    python jefferson_tpu_torch/examples/01_offline_render.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.trajectory.trajectory import CircularOrbit
from jefferson_tpu_torch.viz.html import scene_html
from jefferson_tpu_torch.viz.scene import scene_svg, waveform_svg
from jefferson_tpu_torch.viz.scene3d import scene3d_html


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    cfg = jt.DEFAULT_CONFIG
    db = jt.synthetic_database(cfg)  # or jt.load_database("/path/to/kemar")

    # 3 seconds of a plucky test tone
    sr = cfg.sample_rate
    t = np.arange(3 * sr) / sr
    sig = (0.4 * np.sin(2 * np.pi * 330 * t) * np.exp(-(t % 0.5) * 8)).astype(np.float32)

    traj = CircularOrbit(period_s=3.0, ele=15, r=1.5)
    blocks = len(sig) // cfg.frames_per_buffer
    positions = traj.sample(blocks, cfg)

    out = Renderer(db, cfg, device=args.device).render(sig, positions)
    jt.write_wav("orbit.wav", out, sr)  # 24-bit PCM like the reference
    scene_svg(positions, "orbit.scene.svg", config=cfg)
    waveform_svg(out, "orbit.wave.svg")
    # self-contained players: the 2-D synced scene and the 3-D perspective
    # view (mouse-orbit/zoom with the reference GL window's camera)
    scene_html(positions, out, "orbit.html", config=cfg)
    scene3d_html(positions, out, "orbit.3d.html", config=cfg)
    print(f"rendered {out.shape[0]/sr:.1f}s on {args.device} -> orbit.wav "
          f"(+ .scene.svg, .wave.svg, .html, .3d.html)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
