"""Render daemon end to end on the card: serve, stream, move, WATCH the
scene live.  (The port's copy of ``examples/08_daemon_live_viz.py``.)

The reference draws the listener + source in a GLUT window at ~100 Hz
while audio plays (reference: Jefferson/src/graphics.cu:352-453).  The
headless equivalent is three cooperating pieces, all shown here in one
process (in production each is its own):

1. jefferson-torch-serve      — the resident render daemon (Unix socket)
2. a client                   — starts a live stream and moves the source
3. jefferson-torch-live-viz   — polls stream_status, rewrites live.svg
                                (+ a self-refreshing live.html for a browser)

    python jefferson_tpu_torch/examples/08_daemon_live_viz.py [--device cpu]
"""

import argparse
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.serve import RenderService, request, serve
from jefferson_tpu_torch.viz.live import watch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    cfg = jt.DEFAULT_CONFIG
    td = Path(tempfile.mkdtemp(prefix="jt_ex08_"))
    sock = td / "jt.sock"

    # a test tone to spatialize
    sr = cfg.sample_rate
    tone = (0.3 * np.sin(2 * np.pi * 440 * np.arange(2 * sr) / sr)).astype(np.float32)
    jt.write_wav(td / "in.wav", np.stack([tone, tone], 1), sr)

    # 1) the daemon (in production: `python -m jefferson_tpu_torch.serve --socket …`)
    service = RenderService(hrtf_dir=None, chunk_blocks=256, device=args.device)
    threading.Thread(target=serve, args=(sock, service), daemon=True).start()
    # bounded startup wait: a daemon that dies before binding must fail
    # loudly, not spin forever
    for _ in range(1200):
        try:
            if request(sock, {"cmd": "ping"}).get("pong"):
                break
        except OSError:
            time.sleep(0.05)
    else:
        raise SystemExit(f"daemon did not come up on {sock} within 60 s")

    # 2) a live stream session + a scripted "user" moving the source
    resp = request(sock, {"cmd": "stream_start", "input": str(td / "in.wav"),
                          "output": str(td / "live.wav"), "seconds": 4, "paced": True})
    if not resp["ok"]:
        raise SystemExit(f"stream_start failed: {resp}")
    print("stream session:", resp["session"])

    def mover():
        for azi in range(0, 360, 30):
            time.sleep(0.3)
            request(sock, {"cmd": "move", "azi": azi, "ele": 10, "r": 1.0})

    threading.Thread(target=mover, daemon=True).start()

    # 3) the live scene view: polls stream_status at ~20 Hz until the stream
    #    ends, rewriting live.svg atomically (open live.html in a browser)
    final = watch(sock, td / "live.svg", interval_s=0.05)
    print("stream ended:", final.get("blocks"), "blocks,",
          "final position azi", final.get("azi"))
    print("artifacts:", td / "live.svg", td / "live.html", td / "live.wav")

    stats = request(sock, {"cmd": "stream_stop"})
    print("deadline stats:", {k: stats[k] for k in ("blocks", "avg_ms", "misses")})
    request(sock, {"cmd": "shutdown"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
