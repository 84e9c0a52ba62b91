"""Interactive HTML scene player — the closest headless analogue of the
reference's live GL window (reference: Jefferson/src/graphics.cu:352-453:
listener + moving source sphere redrawn each frame while audio plays).

``scene_html`` writes one self-contained file: the rendered binaural audio
embedded as a base64 WAV in an <audio> element, a top-down scene whose
source marker is animated in sync with playback (position interpolated from
the per-block trajectory), elevation/radius readouts, and the stereo
waveform ribbon with a playhead.  No external assets or network needed —
open it in any browser.

A copy of ``jefferson_tpu/viz/html.py``, pinned byte for byte to it by
``tests/test_torch_viz.py``; the embedded WAV comes from the port's
``io.wavio`` codec.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from .scene import decimate_waveform


def _wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    from ..io.wavio import _encode, _header

    x = np.asarray(samples)
    channels = 1 if x.ndim == 1 else x.shape[1]
    payload = _encode(x, 16, False)
    return _header(sample_rate, channels, 16, False, len(payload)) + payload


def scene_html(
    positions: np.ndarray,
    samples: np.ndarray,
    path: str | Path,
    config: EngineConfig = DEFAULT_CONFIG,
    size: int = 520,
    title: str = "jefferson_tpu render",
) -> None:
    """Write a self-contained interactive player.

    positions: (B, 3) per-block (azi_deg, ele_deg, r); samples: (N, 2) f32.
    """
    pos = np.asarray(positions, dtype=np.float64)
    if pos.size == 0:
        raise ValueError("scene_html needs at least one position")
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 1:
        samples = samples[:, None].repeat(2, axis=1)
    sr = config.sample_rate
    # never 0: the player's tick() divides by DUR (NaN frame index)
    dur = max(samples.shape[0] / sr, 1e-6)

    azi = np.deg2rad(pos[:, 0])
    r = pos[:, 2]
    rmax = max(float(np.max(r)), 1e-6) * 1.2
    s = size / 2 / rmax
    cx = cy = size / 2
    # reference convention: azi 0 = -z (ahead); screen y down so ahead is up
    px = cx + r * np.sin(azi) * s
    py = cy + (-r * np.cos(azi)) * s

    # decimate the trajectory for the JS payload (≤ 2000 keyframes)
    step = max(1, len(pos) // 2000)
    frames = [
        [round(float(px[i]), 1), round(float(py[i]), 1),
         round(float(pos[i, 0]), 1), round(float(pos[i, 1]), 1),
         round(float(pos[i, 2]), 2)]
        for i in range(0, len(pos), step)
    ]
    pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px[::step], py[::step]))
    rings = "".join(
        f'<circle cx="{cx}" cy="{cy}" r="{rad * s:.1f}" fill="none" '
        f'stroke="#ddd" stroke-width="1"/>'
        for rad in np.linspace(rmax / 3, rmax, 3)
    )

    wav_b64 = base64.b64encode(_wav_bytes(samples, sr)).decode()

    # waveform envelope polygon (960 bins, mono mix)
    env = decimate_waveform(samples.mean(axis=1), 960)
    peak = max(float(env.max()), 1e-9)
    w_w, w_h = size, 110
    up = " ".join(f"{i * w_w / len(env):.1f},{w_h/2 - e / peak * w_h * 0.45:.1f}"
                  for i, e in enumerate(env))
    dn = " ".join(f"{i * w_w / len(env):.1f},{w_h/2 + e / peak * w_h * 0.45:.1f}"
                  for i, e in reversed(list(enumerate(env))))

    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; background:#fafafa; color:#222;
        display:flex; flex-direction:column; align-items:center; gap:10px; }}
 .readout {{ font: 13px monospace; color:#555; }}
 svg {{ background:white; border:1px solid #e5e5e5; border-radius:8px; }}
</style></head>
<body>
<h3>{title}</h3>
<svg id="scene" width="{size}" height="{size}" viewBox="0 0 {size} {size}">
 {rings}
 <text x="{cx}" y="16" font-size="12" text-anchor="middle" fill="#888">ahead (azi 0)</text>
 <polyline points="{pts}" fill="none" stroke="#2a7" stroke-width="2" opacity="0.55"/>
 <circle cx="{cx}" cy="{cy}" r="8" fill="#222"/>
 <circle id="src" cx="{px[0]:.1f}" cy="{py[0]:.1f}" r="7" fill="#c33">
   <title>sound source</title></circle>
</svg>
<div class="readout" id="ro">azi — · ele — · r —</div>
<svg width="{w_w}" height="{w_h}" viewBox="0 0 {w_w} {w_h}">
 <polygon points="{up} {dn}" fill="#27c" opacity="0.7"/>
 <line id="ph" x1="0" y1="0" x2="0" y2="{w_h}" stroke="#c33" stroke-width="2"/>
</svg>
<audio id="au" controls src="data:audio/wav;base64,{wav_b64}"></audio>
<script>
const F = {json.dumps(frames)};
const DUR = {dur:.6f};
const au = document.getElementById('au'), src = document.getElementById('src');
const ph = document.getElementById('ph'), ro = document.getElementById('ro');
function tick() {{
  const t = Math.min(au.currentTime / DUR, 1);
  const i = Math.min(Math.floor(t * (F.length - 1)), F.length - 1);
  const f = F[i];
  src.setAttribute('cx', f[0]); src.setAttribute('cy', f[1]);
  ro.textContent = `azi ${{f[2]}}° · ele ${{f[3]}}° · r ${{f[4]}}`;
  ph.setAttribute('x1', t * {w_w}); ph.setAttribute('x2', t * {w_w});
  requestAnimationFrame(tick);
}}
requestAnimationFrame(tick);
</script>
</body></html>
"""
    Path(path).write_text(html, encoding="utf-8")
