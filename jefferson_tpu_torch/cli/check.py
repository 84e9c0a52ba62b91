"""jefferson-torch-check — WAV precision gate: a copy of
``jefferson_tpu/cli/check.py``, pinned to the original by
``tests/test_torch_cli.py``.

Equivalent of the reference's external gate (reference:
Jefferson/Precision_Check.py:5-16): compare two rendered WAVs sample by
sample and fail if max |a-b| exceeds epsilon (default 2e-7, the reference's
GPU-vs-CPU tolerance).  Also reports RMS error against the 1e-4 budget.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jefferson-torch-check")
    p.add_argument("file_a")
    p.add_argument("file_b")
    p.add_argument("--eps", type=float, default=2e-7, help="max |diff| gate (default 2e-7)")
    p.add_argument("--rms", type=float, default=1e-4, help="RMS error gate (default 1e-4)")
    args = p.parse_args(argv)

    from ..io.wavio import read_wav
    from ..testing import precision_check

    a, sr_a = read_wav(args.file_a)
    b, sr_b = read_wav(args.file_b)
    if sr_a != sr_b:
        print(f"FAIL: sample rates differ ({sr_a} vs {sr_b})")
        return 1
    if a.shape[1] != b.shape[1]:
        print(f"FAIL: channel counts differ ({a.shape[1]} vs {b.shape[1]})")
        return 1
    n = min(len(a), len(b))
    length_ok = len(a) == len(b)
    if not length_ok:
        # a truncated or header-only render is a FAILURE, not a footnote —
        # the reference gate's intent is sample-by-sample over the whole
        # file; the prefix diff below is printed for diagnostics only
        print(f"FAIL: lengths differ ({len(a)} vs {len(b)} frames); "
              f"prefix diff over the first {n}:")
    if n == 0:
        print("Failed precision check")
        return 1
    rep = precision_check(a[:n], b[:n], eps=args.eps)
    rms_ok = rep.rms <= args.rms
    print(f"max|diff| = {rep.max_abs_diff:.3e} @ frame {rep.max_index // a.shape[1]} "
          f"(gate {args.eps:.1e}) -> {'OK' if rep.ok else 'FAIL'}")
    print(f"rms = {rep.rms:.3e} (gate {args.rms:.1e}) -> {'OK' if rms_ok else 'FAIL'}")
    if rep.ok and rms_ok and length_ok:
        print("Passed precision check")
        return 0
    print("Failed precision check")
    return 1


if __name__ == "__main__":
    sys.exit(main())
