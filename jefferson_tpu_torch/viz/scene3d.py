"""Perspective 3-D scene view — the reference's GL window, self-contained.

The reference renders a perspective OpenGL scene (floor mesh, listener
model at the origin, source sphere) with mouse-drag rotation and wheel
zoom while audio plays (reference: Jefferson/src/graphics.cu:352-453
display; :537-601 mouse/motion handlers).  This module reproduces that
experience headlessly as ONE self-contained HTML file: an inline-JS
perspective projector onto a <canvas> (no WebGL, no external assets),
with the reference's exact camera semantics:

  * left-drag   — rotate_x += dy * 0.2, rotate_y += dx * 0.2 (degrees)
  * right-drag  — translate_z += dy * 0.01 (dolly)
  * wheel       — translate_z +- 0.1 per notch
  * 'r'         — reset camera to rotate 0/0, translate_z = -3
  (graphics.cu:559-601; initial camera graphics.cu 'r' case :496-499)

Two products:

  * ``scene3d_html`` — offline player: rendered audio embedded as base64
    WAV, source sphere animated along the trajectory in sync with
    playback (the 3-D sibling of viz.html.scene_html).
  * ``live3d_html`` — in-play view: polls a ``.js`` state sibling (of the
    JSON status file) that viz.live's ``watch(..., three_d=True)``
    rewrites from the daemon's stream_status at the reference's ~100 Hz
    cadence — script-tag injection so the page works from ``file://``.

World frame = the engine's: x right, y up, z toward the listener's back
(azi 0 = -z, trajectory/spatial.spherical_to_cartesian).  The camera uses
the reference's GL order (rotate_x about X, then rotate_y about Y, then
translate_z) looking down -z.

A copy of ``jefferson_tpu/viz/scene3d.py``, pinned byte for byte to it by
``tests/test_torch_viz.py``.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from ..trajectory.spatial import spherical_to_cartesian


def _scene3d_js(canvas_id: str = "c3d") -> str:
    """Shared projector + painter + camera interaction (reference
    semantics, see module docstring).  Exposes window.JT3D = {draw(state),
    resetCam()} where state = {x, y, z, trail: [[x,y,z]...], label,
    clipping, frac}."""
    return """
const CV = document.getElementById('%(cid)s');
const CTX = CV.getContext('2d');
const W = CV.width, H = CV.height, D2R = Math.PI / 180;
const cam = { rx: 20, ry: -30, tz: -3 };   // gentle initial orbit
function resetCam() { cam.rx = 0; cam.ry = 0; cam.tz = -3; }  // 'r' (ref)
let drag = null;
CV.addEventListener('mousedown', e => { drag = {b: e.button, x: e.clientX, y: e.clientY}; e.preventDefault(); });
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.b === 0) { cam.rx += dy * 0.2; cam.ry += dx * 0.2; }      // rotate
  else if (drag.b === 2) { cam.tz += dy * 0.01; }                    // dolly
  drag.x = e.clientX; drag.y = e.clientY;
});
CV.addEventListener('wheel', e => { cam.tz += (e.deltaY < 0 ? 0.1 : -0.1); e.preventDefault(); });
CV.addEventListener('contextmenu', e => e.preventDefault());
window.addEventListener('keydown', e => { if (e.key === 'r') resetCam(); });
function proj(p) {
  const cx = Math.cos(cam.rx * D2R), sx = Math.sin(cam.rx * D2R);
  const cy = Math.cos(cam.ry * D2R), sy = Math.sin(cam.ry * D2R);
  let x = p[0] * cy + p[2] * sy, z = -p[0] * sy + p[2] * cy, y = p[1];
  let y2 = y * cx - z * sx, z2 = y * sx + z * cx;
  z2 += cam.tz;
  const d = -z2;                       // camera looks down -z
  const f = 0.9 * H / Math.max(d, 0.12);
  return [W / 2 + x * f, H / 2 - y2 * f, d];
}
function line3(a, b, style, width) {
  const pa = proj(a), pb = proj(b);
  if (pa[2] <= 0.12 || pb[2] <= 0.12) return;
  CTX.strokeStyle = style; CTX.lineWidth = width || 1;
  CTX.beginPath(); CTX.moveTo(pa[0], pa[1]); CTX.lineTo(pb[0], pb[1]); CTX.stroke();
}
function sphere3(p, rad, fill) {
  const q = proj(p);
  if (q[2] <= 0.12) return;
  CTX.fillStyle = fill;
  CTX.beginPath(); CTX.arc(q[0], q[1], rad * 0.9 * H / q[2], 0, 2 * Math.PI); CTX.fill();
}
function draw(st) {
  CTX.fillStyle = '#10141c'; CTX.fillRect(0, 0, W, H);
  // floor grid at y = -1 (the reference's CUDA-generated floor mesh)
  for (let i = -3; i <= 3; i++) {
    line3([i * 0.5, -1, -1.5], [i * 0.5, -1, 1.5], '#2a3244');
    line3([-1.5, -1, i * 0.5], [1.5, -1, i * 0.5], '#2a3244');
  }
  // world axes hint: ahead (-z) marker
  line3([0, -1, 0], [0, -1, -1.5], '#3d4f6e', 2);
  const fwd = proj([0, -1, -1.6]);
  if (fwd[2] > 0.12) { CTX.fillStyle = '#7f96bd'; CTX.font = '12px monospace';
    CTX.fillText('ahead (azi 0)', fwd[0] - 34, fwd[1]); }
  // trail
  (st.trail || []).forEach((p, i) => {
    const a = (0.12 + 0.7 * i / Math.max((st.trail || []).length, 1)).toFixed(2);
    sphere3(p, 0.018, 'rgba(70,190,140,' + a + ')');
  });
  // listener: head at origin facing -z (nose), shoulders hint
  sphere3([0, 0, 0], 0.09, '#d8dee9');
  sphere3([0, 0, -0.11], 0.03, '#d8dee9');       // nose (ahead)
  sphere3([-0.11, -0.02, 0], 0.035, '#aab4c4');  // L ear
  sphere3([0.11, -0.02, 0], 0.035, '#aab4c4');   // R ear
  // source sphere
  sphere3([st.x, st.y, st.z], 0.07, st.clipping ? '#e05555' : '#5aa0e6');
  line3([st.x, -1, st.z], [st.x, st.y, st.z], '#33415c');  // drop line
  // HUD
  CTX.fillStyle = '#c7d0dd'; CTX.font = '13px monospace';
  CTX.fillText(st.label || '', 12, 20);
  if (st.frac !== undefined) {
    CTX.fillStyle = '#243049'; CTX.fillRect(12, H - 18, W - 24, 6);
    CTX.fillStyle = st.alive === false ? '#667' : '#46be8c';
    CTX.fillRect(12, H - 18, (W - 24) * Math.min(st.frac, 1), 6);
  }
  CTX.fillStyle = '#5c6b82'; CTX.font = '11px monospace';
  CTX.fillText('drag: orbit \\u00b7 right-drag/wheel: zoom \\u00b7 r: reset', 12, H - 28);
}
window.JT3D = { draw, resetCam, cam };
""" % {"cid": canvas_id}


def scene3d_html(
    positions: np.ndarray,
    samples: np.ndarray,
    path: str | Path,
    config: EngineConfig = DEFAULT_CONFIG,
    size: int = 640,
    title: str = "jefferson_tpu render (3-D)",
) -> None:
    """Write a self-contained 3-D player: embedded audio + perspective
    scene with the source animated along the trajectory (positions (B, 3)
    = per-block azi/ele/r; samples (N, 2) float32)."""
    from .html import _wav_bytes

    pos = np.asarray(positions, dtype=np.float64)
    if pos.size == 0:
        raise ValueError("scene3d_html needs at least one position")
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 1:
        samples = samples[:, None].repeat(2, axis=1)
    sr = config.sample_rate
    # never 0: the player's tick() divides by DUR (0 -> NaN frame index,
    # a TypeError every animation frame)
    dur = max(samples.shape[0] / sr, 1e-6)
    xyz = np.stack(
        [spherical_to_cartesian(p[0], p[1], p[2]) for p in pos]
    ).astype(np.float64)
    # normalize the scene so the farthest point sits inside the grid
    scale = 1.0 / max(float(np.max(np.linalg.norm(xyz, axis=1))), 1e-6)
    xyz = xyz * min(scale, 1.0) * 1.2
    step = max(1, len(pos) // 2000)
    frames = [
        [round(float(xyz[i, 0]), 3), round(float(xyz[i, 1]), 3),
         round(float(xyz[i, 2]), 3),
         round(float(pos[i, 0]), 1), round(float(pos[i, 1]), 1),
         round(float(pos[i, 2]), 2)]
        for i in range(0, len(pos), step)
    ]
    wav_b64 = base64.b64encode(_wav_bytes(samples, sr)).decode()
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style> body {{ font-family: system-ui, sans-serif; background:#0b0e14; color:#c7d0dd;
  display:flex; flex-direction:column; align-items:center; gap:10px; }} </style></head>
<body>
<h3>{title}</h3>
<canvas id="c3d" width="{size}" height="{size}"></canvas>
<audio id="au" controls src="data:audio/wav;base64,{wav_b64}"></audio>
<script>
{_scene3d_js()}
const F = {json.dumps(frames)};
const DUR = {dur:.6f};
const au = document.getElementById('au');
const TRAIL = 90;
function tick() {{
  const t = Math.min(au.currentTime / DUR, 1);
  const i = Math.min(Math.floor(t * (F.length - 1)), F.length - 1);
  const f = F[i];
  const trail = [];
  for (let k = Math.max(0, i - TRAIL); k < i; k++)
    trail.push([F[k][0], F[k][1], F[k][2]]);
  JT3D.draw({{
    x: f[0], y: f[1], z: f[2], trail,
    label: `azi ${{f[3]}}\\u00b0 \\u00b7 ele ${{f[4]}}\\u00b0 \\u00b7 r ${{f[5]}}`,
    frac: t,
  }});
  requestAnimationFrame(tick);
}}
requestAnimationFrame(tick);
</script>
</body></html>
"""
    Path(path).write_text(html, encoding="utf-8")


def live3d_html(state_path: str | Path, interval_ms: int = 100,
                size: int = 640) -> str:
    """Self-contained live 3-D view: polls the sibling ``.js`` state file
    (rewritten by viz.live.watch(..., three_d=True)) at the reference's
    ~100 Hz redraw cadence and repaints the perspective scene.

    The poll re-injects a <script src=".js?ts"> tag instead of fetch():
    browsers block fetch/XHR on file:// URLs, and the documented workflow
    (like the 2-D page, whose <img> refresh is allowed from disk) is
    opening the file directly — script loads are permitted there."""
    name = Path(state_path).with_suffix(".js").name
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>jefferson_tpu live scene (3-D)</title>
<style> body {{ margin:0; background:#0b0e14; display:flex; justify-content:center; }} </style></head>
<body>
<canvas id="c3d" width="{size}" height="{size}"></canvas>
<script>
{_scene3d_js()}
window.JT3D_STATE = {{x: 0, y: 0, z: -0.5, trail: [], label: 'waiting for stream\\u2026'}};
function poll() {{
  const el = document.createElement('script');
  el.async = false;  // keep poll order: an async pair can execute out of
                     // order and regress the state to an older snapshot
  el.src = '{name}?' + Date.now();
  el.onload = el.onerror = () => el.remove();
  document.body.appendChild(el);
}}
function tick() {{ JT3D.draw(window.JT3D_STATE); requestAnimationFrame(tick); }}
setInterval(poll, {interval_ms});
poll(); requestAnimationFrame(tick);
</script>
</body></html>
"""


def live3d_state(status: dict, trail: list | None = None) -> dict:
    """Map one daemon stream_status reply -> the JSON the live 3-D page
    draws (world xyz + HUD fields).

    The status carries CONTROL-space cartesian (the reference's reading
    convention azi = atan2(-x, -z), SoundSource.cu:20-36, in which the
    heard-RIGHT is -x); the painter's world frame puts the R ear at +x
    (matching the offline views' spherical_to_cartesian and what the
    audio does), so x negates on the way in — source and trail alike."""
    blocks = int(status.get("blocks", 0))
    total = max(int(status.get("total_blocks", 1)), 1)
    return {
        "x": -float(status.get("x", 0.0)),
        "y": float(status.get("y", 0.0)),
        "z": float(status.get("z", -0.5)),
        "trail": [[-float(p[0]), float(p[1]), float(p[2])] for p in (trail or [])],
        "label": (
            f"azi {status.get('azi', 0):.0f}° · "
            f"ele {status.get('ele', 0):.0f}° · "
            f"r {status.get('r', 0):.2f} · block {blocks}/{total}"
            + ("" if status.get("alive", False) else " (ended)")
        ),
        "frac": min(blocks / total, 1.0),
        "alive": bool(status.get("alive", False)),
        "clipping": bool(status.get("clipping", False)),
    }
