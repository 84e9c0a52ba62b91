"""Daemon soak: sustained mixed load on one resident RenderService on the
card.  Counterpart of the JAX package's ``scripts/soak_daemon.py``.

Offline renders, multi-source scenes, live stream sessions with
mid-stream moves and status polls, session churn (starts and stops
overlapping), deliberate error requests (isolation) and socket handling,
for ``--minutes`` (31 by default), asserting bounded host RSS and zero
unexpected errors.  One process hosts the daemon (an in-process server
thread) and the client loops, so the RSS covers the whole serving stack.
Each interval reports the host RSS and, on the card, the CUDA caching
allocator's ``memory_allocated`` and ``memory_reserved``.

    python -m jefferson_tpu_torch.scripts.soak_daemon --minutes 31 [--device cpu]

Prints one JSON line: the counts, the daemon's error counter, the RSS at
start, peak and end, and every interval's memory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time


def rss_mib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def memory(device, t0: float) -> dict:
    """One interval's memory: host RSS and, on the card, the allocator's."""
    import torch

    rec = {"minutes": round((time.time() - t0) / 60, 3), "rss_mib": round(rss_mib(), 1)}
    if device.type == "cuda":
        rec["allocated_mib"] = round(torch.cuda.memory_allocated(device) / 2**20, 1)
        rec["reserved_mib"] = round(torch.cuda.memory_reserved(device) / 2**20, 1)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="soak_daemon", description=__doc__.splitlines()[0])
    p.add_argument("--minutes", type=float, default=31.0)
    p.add_argument("--report-every", type=float, default=120.0,
                   help="seconds between interval reports")
    p.add_argument("--rss-budget-mib", type=float, default=4000.0,
                   help="max allowed RSS growth (peak - start)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the card (the default; raises without one); cpu = the "
                        "kernels' plain twins")
    args = p.parse_args(argv)

    import numpy as np

    from ..io.wavio import write_wav
    from ..serve import RenderService, request, serve

    td = tempfile.mkdtemp(prefix="jt_soak_")
    sock = os.path.join(td, "jt.sock")
    rng = np.random.default_rng(0)
    sr = 44100
    sig = (0.25 * rng.standard_normal(sr)).astype(np.float32)
    wav = os.path.join(td, "in.wav")
    write_wav(wav, np.stack([sig, sig], 1), sr)
    scene = {"sources": [{"input": wav, "trajectory": f"orbit:period=2,start={i * 90}"}
                         for i in range(4)]}

    service = RenderService(hrtf_dir=None, chunk_blocks=256, device=args.device)
    device = service.device
    threading.Thread(target=serve, args=(sock, service), daemon=True).start()
    # a startup wait on its own budget: a server that never comes up must
    # fail in seconds with the JSON line, not spin for the whole soak
    up_deadline = time.time() + 120.0
    up = False
    while time.time() < up_deadline:
        try:
            if request(sock, {"cmd": "ping"}).get("pong"):
                up = True
                break
        except OSError:
            time.sleep(0.1)
    if not up:
        print(json.dumps({"soak": "daemon", "ok": False,
                          "error": "daemon did not come up within 120 s"}))
        return 1

    counts = {"render": 0, "scene": 0, "stream": 0, "move": 0, "status": 0,
              "expected_errors": 0}
    failures: list[str] = []

    # warm-up outside the soak's accounting: each request class's first
    # call allocates its buffers
    out_warm = os.path.join(td, "warm.wav")
    scene_spec = {"sources": [{"input": wav, "trajectory": "orbit:period=2"}] * 4}
    for tag, req_w in (
        ("render", {"cmd": "render", "input": wav, "output": out_warm,
                    "trajectory": "orbit:period=1", "blocks": 128}),
        ("scene", {"cmd": "scene", "scene": scene_spec, "output": out_warm,
                   "blocks": 64, "chunk_blocks": 64}),
    ):
        t0 = time.time()
        r = request(sock, req_w, timeout=1800)
        print(f"warmup {tag}: {time.time()-t0:.1f}s ok={r.get('ok')}", file=sys.stderr)
        if not r.get("ok"):
            print(json.dumps({"soak": "daemon", "ok": False,
                              "failures": [f"warmup {tag}: {r}"]}))
            return 1

    t_start = time.time()
    intervals = [memory(device, t_start)]
    rss0 = intervals[0]["rss_mib"]
    rss_peak = rss0
    print(f"soak start: {intervals[0]}, {args.minutes:g} min", file=sys.stderr)
    deadline = t_start + args.minutes * 60

    def check(resp, ok=True, tag=""):
        if bool(resp.get("ok")) != ok:
            failures.append(f"{tag}: {resp}")

    trajs = ["orbit:period=1", "orbit:period=2,ele=30",
             "static:azi=90,ele=0,r=1.0", "sweep:start=0,blocks=16,steps=8"]
    out_render = os.path.join(td, "r.wav")
    out_scene = os.path.join(td, "s.wav")
    last_report = t_start
    i = 0
    while time.time() < deadline:
        i += 1
        # 1) offline render (fixed 128 blocks)
        check(request(sock, {"cmd": "render", "input": wav, "output": out_render,
                             "trajectory": trajs[i % len(trajs)], "blocks": 128}),
              tag="render")
        counts["render"] += 1
        # 2) every 3rd iteration: a 4-source scene
        if i % 3 == 0:
            check(request(sock, {"cmd": "scene", "scene": scene, "output": out_scene,
                                 "blocks": 64, "chunk_blocks": 64}), tag="scene")
            counts["scene"] += 1
        # 3) stream churn: two overlapping sessions, moves + status, stop
        s1 = request(sock, {"cmd": "stream_start", "input": wav,
                            "output": os.path.join(td, "l1.wav"),
                            "seconds": 2.0, "paced": False})
        check(s1, tag="stream_start")
        s2 = request(sock, {"cmd": "stream_start", "input": wav,
                            "output": os.path.join(td, "l2.wav"),
                            "seconds": 3.0, "paced": True})
        check(s2, tag="stream_start2")
        counts["stream"] += 2
        for k in range(4):
            m = request(sock, {"cmd": "move", "session": s2.get("session"),
                               "azi": (45 * k) % 360, "ele": 10, "r": 1.0})
            # a move after the paced session's natural end is rejected as
            # ended: correct behavior, not a failure
            if not m.get("ok") and "ended" not in str(m.get("error", "")):
                failures.append(f"move: {m}")
            counts["move"] += 1
            st = request(sock, {"cmd": "stream_status", "session": s2.get("session")})
            if not st.get("ok") and "no stream session" not in str(st.get("error", "")):
                failures.append(f"status: {st}")
            counts["status"] += 1
        check(request(sock, {"cmd": "stream_stop", "session": s1.get("session")}),
              tag="stop1")
        check(request(sock, {"cmd": "stream_stop", "session": s2.get("session")}),
              tag="stop2")
        # 4) deliberate errors must isolate (ok:false, daemon alive)
        check(request(sock, {"cmd": "render", "input": os.path.join(td, "absent.wav"),
                             "output": out_render}), ok=False, tag="err_isolation")
        check(request(sock, {"cmd": "nope"}), ok=False, tag="unknown_cmd")
        # only the render error passes the daemon's error counter (unknown
        # commands are rejected before the counting handler)
        counts["expected_errors"] += 1

        rss_peak = max(rss_peak, rss_mib())
        if failures:
            break
        if time.time() - last_report > args.report_every:
            last_report = time.time()
            intervals.append(memory(device, t_start))
            st = request(sock, {"cmd": "stats"})
            print(f"{intervals[-1]} (peak RSS {rss_peak:.0f} MiB), renders "
                  f"{st.get('renders')}, errors {st.get('errors')}", file=sys.stderr)

    stats = request(sock, {"cmd": "stats"})
    request(sock, {"cmd": "shutdown"})
    intervals.append(memory(device, t_start))
    minutes = (time.time() - t_start) / 60
    # the daemon's error counter equals the deliberate errors exactly, and
    # memory stays bounded across the session churn
    daemon_errors = int(stats.get("errors", -1))
    rss_ok = (rss_peak - rss0) <= args.rss_budget_mib
    ok = (not failures) and daemon_errors == counts["expected_errors"] and rss_ok
    print(json.dumps({
        "soak": "daemon", "device": str(device), "minutes": round(minutes, 2), "ok": ok,
        "iterations": i, **counts,
        "daemon_errors": daemon_errors,
        "rss_start_mib": round(rss0), "rss_end_mib": round(intervals[-1]["rss_mib"]),
        "rss_peak_mib": round(rss_peak), "rss_ok": rss_ok,
        "intervals": intervals,
        "failures": failures[:5],
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
