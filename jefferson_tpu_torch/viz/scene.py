"""Offline scene visualization (SVG) — the OpenGL/GLUT window re-imagined:
a copy of ``jefferson_tpu/viz/scene.py``, pinned byte for byte to it by
``tests/test_torch_viz.py``.

The reference renders the listener, the movable source sphere and a
(disabled) waveform ribbon in a GLUT window (reference:
Jefferson/src/graphics.cu:352-453, Jefferson/src/vbo.cu).  The port is
headless; the equivalents are file artifacts:

  * ``scene_svg``     — top-down scene: listener at the origin, trajectory
                        path colored by time, start/end markers.
  * ``waveform_svg``  — decimated stereo waveform ribbon; decimation uses
                        mean-pooling of |x| like the reference's
                        averagingKernel (reference: Jefferson/src/kernels.cu:208-232).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig


def decimate_waveform(x: np.ndarray, bins: int = 1024) -> np.ndarray:
    """Mean |amplitude| per bin (the averagingKernel analogue)."""
    x = np.abs(np.asarray(x, dtype=np.float32))
    n = len(x)
    if n == 0:
        return np.zeros(bins, np.float32)
    edge = (n // bins) * bins
    if edge == 0:
        pad = np.zeros(bins, np.float32)
        pad[:n] = x
        return pad
    # reaching here implies n >= bins (edge == 0 covered the short case)
    return x[:edge].reshape(bins, -1).mean(axis=1)


def scene_svg(
    positions: np.ndarray,
    path: str | Path,
    size: int = 640,
    config: EngineConfig = DEFAULT_CONFIG,
) -> None:
    """Write a top-down SVG of the trajectory: (B, 3) spherical positions."""
    pos = np.asarray(positions, dtype=np.float64)
    if pos.size == 0:
        raise ValueError("scene_svg needs at least one position")
    azi = np.deg2rad(pos[:, 0])
    r = pos[:, 2]
    # reference convention: azi 0 = -z (ahead), +x to the right of the listener
    x = r * np.sin(azi)
    z = -r * np.cos(azi)
    rmax = max(float(np.max(r)), 1e-6) * 1.2
    s = size / 2 / rmax
    cx = cy = size / 2
    px = cx + x * s
    py = cy + z * s  # screen y down = -z ahead up

    pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
    rings = "".join(
        f'<circle cx="{cx}" cy="{cy}" r="{rad * s:.1f}" fill="none" '
        f'stroke="#ccc" stroke-width="1"/>'
        for rad in np.linspace(rmax / 3, rmax, 3)
    )
    svg = f"""<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" viewBox="0 0 {size} {size}">
<rect width="100%" height="100%" fill="white"/>
{rings}
<text x="{cx}" y="14" font-size="11" text-anchor="middle" fill="#888">ahead (azi 0)</text>
<polyline points="{pts}" fill="none" stroke="#2a7" stroke-width="2" opacity="0.8"/>
<circle cx="{px[0]:.1f}" cy="{py[0]:.1f}" r="5" fill="#27c"/>
<circle cx="{px[-1]:.1f}" cy="{py[-1]:.1f}" r="5" fill="#c33"/>
<circle cx="{cx}" cy="{cy}" r="7" fill="#222"/>
<text x="{cx + 10}" y="{cy + 4}" font-size="11" fill="#222">listener</text>
</svg>
"""
    Path(path).write_text(svg, encoding="utf-8")


def waveform_svg(
    samples: np.ndarray,
    path: str | Path,
    width: int = 960,
    height: int = 240,
    bins: int = 960,
) -> None:
    """Write a stereo (or mono) waveform ribbon SVG."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    chans = x.shape[1]
    lane = height / chans
    parts = ['<rect width="100%" height="100%" fill="white"/>']
    colors = ["#27c", "#c33", "#2a7", "#a70"]
    for c in range(chans):
        env = decimate_waveform(x[:, c], bins)
        peak = max(float(env.max()), 1e-9)
        mid = lane * (c + 0.5)
        amp = lane * 0.45 / peak
        up = " ".join(
            f"{i * width / len(env):.1f},{mid - e * amp:.1f}" for i, e in enumerate(env)
        )
        dn = " ".join(
            f"{i * width / len(env):.1f},{mid + e * amp:.1f}"
            for i, e in reversed(list(enumerate(env)))
        )
        parts.append(
            f'<polygon points="{up} {dn}" fill="{colors[c % 4]}" opacity="0.7"/>'
        )
    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">' + "".join(parts) + "</svg>"
    )
    Path(path).write_text(svg, encoding="utf-8")
