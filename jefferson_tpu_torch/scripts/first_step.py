"""The first vector-math call of a fresh process, against the same call again.

MKL's vector math (torch.cos and torch.sin on the CPU) sets itself up on its
first call.  Made first by several threads at once, that call can return
some cosines off the ones every later call returns; the package makes one
call on one thread on import (``jefferson_tpu_torch/__init__.py``).  This
script counts, in fresh processes on the CPU, in three modes: first
``--quiet`` processes of each mode one at a time with nothing else running
(all cores free for the first call's threads), then the modes taken in turn
by ``--workers`` loops at once beside a loop of the graft dryrun (``python
-m jefferson_tpu_torch.graft --device cpu``: four ranks) for ``--seconds``:

- bare: torch alone, the distance planes' cosines (64 x 513, split over
  threads) computed twice;
- port: the same after importing the package;
- stage_a: the graft dryrun's stage (a) in one process, the unsharded
  8-source step of the plain chunk function against its 2-source shards.

Each child prints its largest difference; the last line is one JSON object:
by phase and mode the processes, the differing ones and the largest
difference, and the graft runs' exit codes.

    python -m jefferson_tpu_torch.scripts.first_step [--quiet 20] [--seconds 120]
        [--workers 3]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

MODES = ("bare", "port", "stage_a")


def child(mode: str) -> dict:
    import torch

    if mode == "stage_a":
        import numpy as np

        from jefferson_tpu_torch import graft
        from jefferson_tpu_torch.engine.batch import batched_chunk_fn

        s, nb, ranks = 8, 8, 4
        cfg, _, (spectra, hists, *rest) = graft._example_inputs(s, nb)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        step = batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True)
        run = lambda lo, hi: step(tuple(put(a) for a in spectra), put(hists[lo:hi]),
                                  *(put(a[lo:hi]) for a in rest))[0]
        first = run(0, s)
        again = torch.cat([run(lo, lo + s // ranks) for lo in range(0, s, s // ranks)])
    else:
        if mode == "port":
            import jefferson_tpu_torch  # noqa: F401
        u = torch.rand(64, generator=torch.Generator().manual_seed(0)) * 0.3
        c = u[:, None] * torch.arange(513, dtype=torch.float32)[None, :]
        arg = (2.0 * math.pi) * (c - torch.floor(c))
        first, again = torch.cos(arg), torch.cos(arg)
    return {"mode": mode, "diff": float((first - again).abs().max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quiet", type=int, default=20)
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    rows, graft_rcs, lock = [], [], threading.Lock()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}

    def one(phase: str, mode: str) -> None:
        # the file, not the module: ``-m`` would import the package first
        p = subprocess.run([sys.executable, __file__, "--child", mode], env=env,
                           capture_output=True, text=True, timeout=300)
        last = (p.stdout.strip().splitlines() or [""])[-1]
        with lock:
            rows.append({"phase": phase, **(json.loads(last) if last.startswith("{")
                                            else {"mode": mode, "error": p.returncode})})

    for _ in range(args.quiet):
        for mode in MODES:
            one("quiet", mode)
    end = time.monotonic() + args.seconds

    def loop(k: int) -> None:
        n = k
        while time.monotonic() < end:
            one("loaded", MODES[n % len(MODES)])
            n += 1

    def grafts() -> None:
        while time.monotonic() < end:
            p = subprocess.run([sys.executable, "-m", "jefferson_tpu_torch.graft", "--device",
                                "cpu"], env=env, capture_output=True, text=True, timeout=600)
            graft_rcs.append(p.returncode)

    threads = [threading.Thread(target=loop, args=(k,)) for k in range(args.workers)]
    threads.append(threading.Thread(target=grafts))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    summary = {"graft_rcs": graft_rcs}
    for phase in ("quiet", "loaded"):
        for mode in MODES:
            got = [r for r in rows if (r["phase"], r["mode"]) == (phase, mode)]
            summary[f"{phase} {mode}"] = {
                "processes": len(got),
                "differing": sum(1 for r in got if r.get("diff") or "error" in r),
                "max_diff": max((r.get("diff", 0.0) for r in got), default=0.0)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
