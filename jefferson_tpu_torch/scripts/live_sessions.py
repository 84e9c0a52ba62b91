"""Live sessions in one render daemon on the card: the block times of N
paced sessions moved every 100 ms, with the sessions taking turns a block
at a time (``RenderService._live``, as the daemon serves) and with each
session's thread free to run its block whenever it wakes, in turns
(turns, free, free, turns), each in a daemon process of its own.

    python -m jefferson_tpu_torch.scripts.live_sessions [--sessions 4] [--seconds 5]

Prints a line per run (each session's median, p90, p99 and misses) and a
JSON line of every run's numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

MODES = ("turns", "free", "free", "turns")
# seconds past its length that a session may take to play its blocks
SESSION_GRACE_S = 30.0


def serve_mode(sock: str, free: bool, device: str) -> int:
    """The daemon, its sessions free of the turns when ``free``."""
    from ..serve import RenderService, serve

    service = RenderService(chunk_blocks=2048, device=device)
    if free:
        service._live = contextlib.nullcontext()
    serve(sock, service)
    return 0


def wait_played(sock, sids, deadline: float) -> None:
    """Wait until each session has played all its blocks (its thread has
    ended), polling ``stream_status``; a loaded host starts a session's
    thread late, so a fixed wall time stops it short.  Past ``deadline``
    (``time.time()``) raises."""
    from ..serve import request

    for sid in sids:
        while request(sock, {"cmd": "stream_status", "session": sid})["alive"]:
            if time.time() > deadline:
                raise RuntimeError(f"session {sid} still plays past its deadline")
            time.sleep(0.05)


def run_mode(mode: str, wav: Path, work: Path, sessions: int, seconds: float, device: str):
    """One daemon process, ``sessions`` paced sessions -> their stop replies."""
    from ..serve import request

    sock = work / f"{mode}.sock"
    cmd = [sys.executable, "-m", "jefferson_tpu_torch.scripts.live_sessions", "--serve",
           str(sock), "--device", device] + (["--free"] if mode == "free" else [])
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parents[2])
    try:
        t0 = time.time()
        while True:
            try:
                if request(sock, {"cmd": "ping"}).get("pong"):
                    break
            except OSError:
                if proc.poll() is not None or time.time() - t0 > 300:
                    raise RuntimeError(f"the {mode} daemon did not come up") from None
                time.sleep(0.05)
        sids = [request(sock, {"cmd": "stream_start", "input": str(wav),
                               "output": str(work / f"{mode}{i}.wav"), "seconds": seconds,
                               "paced": True})["session"] for i in range(sessions)]
        k, t1 = 0, time.time()
        while time.time() - t1 < seconds + 0.3:
            for sid in sids:
                request(sock, {"cmd": "move", "session": sid, "azi": (7 * k) % 360, "ele": 10})
            k += 1
            time.sleep(0.1)
        wait_played(sock, sids, t1 + seconds + SESSION_GRACE_S)
        stats = [request(sock, {"cmd": "stream_stop", "session": sid}) for sid in sids]
        request(sock, {"cmd": "shutdown"})
        proc.wait(timeout=30)
        return stats
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="live_sessions", description=__doc__.splitlines()[0])
    p.add_argument("--sessions", type=int, default=4)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--serve", default=None, help=argparse.SUPPRESS)  # the daemon's own mode
    p.add_argument("--free", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.serve is not None:
        return serve_mode(args.serve, args.free, args.device)

    import numpy as np

    from ..io.wavio import write_wav

    work = Path(tempfile.mkdtemp(prefix="jt_sessions_"))
    wav = work / "in.wav"
    write_wav(wav, (np.random.default_rng(0).standard_normal(131072) * 0.2).astype(np.float32),
              44100, bits=32, float_format=True)
    runs = []
    for mode in MODES:
        stats = run_mode(mode, wav, work, args.sessions, args.seconds, args.device)
        keys = ("blocks", "median_ms", "p90_ms", "p99_ms", "misses")
        runs.append({"mode": mode, "sessions": [{k: st.get(k) for k in keys} for st in stats]})
        print(f"{mode}: " + "; ".join(
            f"{st.get('median_ms')}/{st.get('p90_ms')}/{st.get('p99_ms')} ms, "
            f"{st.get('misses')} of {st.get('blocks')} over" for st in stats), flush=True)
    print(json.dumps({"sessions": args.sessions, "seconds": args.seconds, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
