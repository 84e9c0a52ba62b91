"""Live in-play scene view — the reference's GLUT redraw loop as a poller.

The reference redraws the listener + source sphere at ~100 Hz *while audio
plays* (reference: Jefferson/src/graphics.cu:352-453, glutTimerFunc 10 ms).
The port is headless, so the live equivalent is a client that polls a
running daemon's ``stream_status`` (jefferson_tpu_torch.serve) and rewrites a
scene SVG — plus a tiny self-refreshing HTML wrapper any browser can keep
open next to the stream:

    python -m jefferson_tpu_torch.serve --socket /tmp/jt.sock &
    # start a stream (stream_start), then:
    python -m jefferson_tpu_torch.viz.live --socket /tmp/jt.sock -o live.svg

The SVG shows the listener at the origin, the source at its CURRENT
position (polled), a fading trail of recent positions, and a progress bar;
it stops when the stream ends.  Works for any session (``--session``).

A copy of ``jefferson_tpu/viz/live.py`` that polls the port's daemon; its
drawing is pinned byte for byte to the original by
``tests/test_torch_viz.py``.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def _audio_space_xz(status: dict) -> tuple[float, float]:
    """Project a stream_status reply to the HEARD top-down point — the same
    (r sin azi, -r cos azi) polar projection viz.scene.scene_svg uses, so
    the live and offline artifacts agree.

    NOT the raw control (x, z): the live control surface speaks the
    reference's CARTESIAN reading convention (azi = atan2(-x, -z),
    SoundSource.cu:20-36), in which the listener's heard-RIGHT is -x —
    plotting raw control x as screen right mirrors the scene left-right
    against the audio (and against the offline views).  Projecting from the
    ROUNDED azi/r that drive the filters also drops the cos(ele)
    foreshortening scene_svg never had."""
    a = float(status.get("azi", 0.0)) * np.pi / 180.0
    r = float(status.get("r", 0.5))
    return r * float(np.sin(a)), -r * float(np.cos(a))


def live_scene_svg(
    status: dict,
    trail: list[tuple[float, float]] | None = None,
    size: int = 640,
) -> str:
    """Render one stream_status reply (+ optional trail of audio-space
    (x, z) points — see _audio_space_xz) as a top-down scene SVG string.
    Same projection as viz.scene.scene_svg: azi 0 = ahead (-z up on
    screen), azi 90 (heard right) to screen right."""
    x, z = _audio_space_xz(status)
    r = float(status.get("r", 0.5))
    trail = trail or []
    rmax = max(r, 1e-6, *(abs(a) for p in trail for a in p), abs(x), abs(z)) * 1.2
    s = size / 2 / rmax
    cx = cy = size / 2
    px, py = cx + x * s, cy + z * s
    rings = "".join(
        f'<circle cx="{cx}" cy="{cy}" r="{rad * s:.1f}" fill="none" '
        f'stroke="#ccc" stroke-width="1"/>'
        for rad in np.linspace(rmax / 3, rmax, 3)
    )
    trail_pts = "".join(
        f'<circle cx="{cx + tx * s:.1f}" cy="{cy + tz * s:.1f}" r="2.5" '
        f'fill="#2a7" opacity="{0.15 + 0.6 * i / max(len(trail), 1):.2f}"/>'
        for i, (tx, tz) in enumerate(trail)
    )
    blocks = int(status.get("blocks", 0))
    total = max(int(status.get("total_blocks", 1)), 1)
    frac = min(blocks / total, 1.0)
    alive = status.get("alive", False)
    clip = status.get("clipping", False)
    label = (
        f"azi {status.get('azi', 0):.0f}°  ele {status.get('ele', 0):.0f}°  "
        f"r {r:.2f}  —  block {blocks}/{total}"
        + ("" if alive else "  (ended)")
        + ("  CLIPPING!" if clip else "")
    )
    return f"""<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" viewBox="0 0 {size} {size}">
<rect width="100%" height="100%" fill="white"/>
{rings}
<text x="{cx}" y="14" font-size="11" text-anchor="middle" fill="#888">ahead (azi 0)</text>
{trail_pts}
<circle cx="{px:.1f}" cy="{py:.1f}" r="7" fill="{'#c33' if clip else '#27c'}"/>
<circle cx="{cx}" cy="{cy}" r="7" fill="#222"/>
<text x="{cx + 10}" y="{cy + 4}" font-size="11" fill="#222">listener</text>
<rect x="20" y="{size - 26}" width="{size - 40}" height="6" fill="#eee"/>
<rect x="20" y="{size - 26}" width="{(size - 40) * frac:.1f}" height="6" fill="{'#2a7' if alive else '#888'}"/>
<text x="20" y="{size - 34}" font-size="12" fill="#222">{label}</text>
</svg>
"""


def live_html(svg_path: str | Path, interval_ms: int = 100) -> str:
    """Self-refreshing HTML wrapper: re-fetches the SVG at the reference's
    ~100 Hz redraw cadence (graphics.cu glutTimerFunc 10 ms is 100 Hz; a
    browser poll of 100 ms is the practical headless equivalent)."""
    name = Path(svg_path).name
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>jefferson_tpu live scene</title></head>
<body style="margin:0;background:#fff">
<img id="scene" src="{name}" style="display:block;margin:auto">
<script>
setInterval(() => {{
  document.getElementById('scene').src = '{name}?' + Date.now();
}}, {interval_ms});
</script>
</body></html>
"""


def watch(
    socket_path: str | Path,
    out_svg: str | Path,
    session: str | None = None,
    interval_s: float = 0.05,
    max_polls: int | None = None,
    trail_len: int = 120,
    write_html: bool = True,
    three_d: bool = False,
) -> dict:
    """Poll a daemon's stream_status and rewrite ``out_svg`` until the
    stream ends (or ``max_polls``).  Returns the final status reply.

    ``three_d``: additionally rewrite ``<out>.json`` AND its ``<out>.js``
    sibling each poll (the 3-D page polls the .js via script-tag injection
    — keep both together if you copy/serve the artifacts) and write the
    perspective canvas page ``<out>.3d.html`` once (mouse-orbit/zoom with
    the reference's camera semantics — viz.scene3d).

    Writes are atomic (tmp + replace) so a browser refreshing mid-write
    never sees a truncated file.
    """
    import json as _json

    from ..serve import request

    out_svg = Path(out_svg)
    if write_html:
        out_svg.with_suffix(".html").write_text(
            live_html(out_svg, interval_ms=max(int(interval_s * 1000), 50)),
            encoding="utf-8",
        )
    out_json = out_svg.with_suffix(".json")
    if three_d:
        from .scene3d import live3d_html

        out_svg.with_suffix(".3d.html").write_text(
            live3d_html(out_json, interval_ms=max(int(interval_s * 1000), 50)),
            encoding="utf-8",
        )
    trail: list[tuple[float, float]] = []
    trail3: list[list[float]] = []
    status: dict = {}
    polls = 0
    while max_polls is None or polls < max_polls:
        req = {"cmd": "stream_status"}
        if session is not None:
            req["session"] = session
        try:
            status = request(socket_path, req)
        except OSError as e:
            # a daemon shutting down mid-watch unlinks its socket; the next
            # poll's connect then raises (ConnectionRefusedError /
            # FileNotFoundError) — end the watch like any other stream end
            # instead of crashing the CLI with a raw traceback
            status = {"ok": False,
                      "error": f"daemon unreachable: {type(e).__name__}: {e}"}
            break
        polls += 1
        if not status.get("ok"):
            break
        trail.append(_audio_space_xz(status))
        del trail[:-trail_len]
        tmp = out_svg.with_suffix(".svg.tmp")
        tmp.write_text(live_scene_svg(status, trail), encoding="utf-8")
        tmp.replace(out_svg)
        if three_d:
            from .scene3d import live3d_state

            trail3.append([float(status.get("x", 0.0)),
                           float(status.get("y", 0.0)),
                           float(status.get("z", -0.5))])
            del trail3[:-trail_len]
            payload = _json.dumps(live3d_state(status, trail3))
            tmpj = out_json.with_suffix(".json.tmp")
            tmpj.write_text(payload, encoding="utf-8")
            tmpj.replace(out_json)
            # .js sibling: what the 3-D page actually polls (script-tag
            # injection works from file://, where fetch() is blocked)
            out_js = out_json.with_suffix(".js")
            tmps = out_js.with_suffix(".js.tmp")
            tmps.write_text(f"window.JT3D_STATE = {payload};", encoding="utf-8")
            tmps.replace(out_js)
        if not status.get("alive", False):
            break
        time.sleep(interval_s)
    return status


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="jefferson-torch-live-viz",
        description="poll a running daemon's live stream and redraw a scene SVG",
    )
    p.add_argument("--socket", default="/tmp/jefferson.sock")
    p.add_argument("-o", "--output", default="live.svg", help="SVG to (re)write")
    p.add_argument("--session", default=None, help="stream session id (optional)")
    p.add_argument("--interval", type=float, default=0.05, help="poll period, s")
    p.add_argument("--no-html", action="store_true",
                   help="skip the self-refreshing HTML wrapper")
    p.add_argument("--3d", dest="three_d", action="store_true",
                   help="also write a perspective 3-D canvas view: "
                        "<out>.3d.html polls the <out>.js state sibling "
                        "(script-tag injection — works from file://; "
                        "<out>.json carries the same state for programmatic "
                        "readers); mouse-orbit + wheel zoom, the "
                        "reference's camera semantics")
    args = p.parse_args(argv)
    status = watch(
        args.socket, args.output, session=args.session,
        interval_s=args.interval, write_html=not args.no_html,
        three_d=args.three_d,
    )
    if not status.get("ok"):
        print(f"stream_status error: {status.get('error')}")
        return 1
    print(f"stream ended at block {status.get('blocks')}/{status.get('total_blocks')}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
