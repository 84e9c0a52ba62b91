"""Blend-stage shootout on the card: torch gathers against the hand-written
double-buffered row-gather blend (row 12).

The counterpart of ``scripts/bench_blend_variants.py``.  Every variant
computes, per extended row b,

    acc[b] = w0*T[i0] + w1*T[i1] + w2*T[i2] + w3*T[i3]   (same fp order)

over the combined-plane table T (710, 4*bins) = [rL | iL | rR | iR]:

  xla16    - four (710, bins) planes, four ``index_select`` row gathers each
  xla4     - the combined table, four row gathers of width 4*bins
  xla2pair - the paired-row table (1420, 8*bins): row i = [T[i] | T[succ(i)]],
             row 710+i = [T[i] | T[i]]; the grid puts i1 in {i0, succ(i0)}
             (i3 likewise), so two gathers fetch all four brackets
  kernel   - ``kernels/dma_blend.dma_blend``: the bracket rows staged in
             shared memory by asynchronous copies, bracket k+1 in flight
             while bracket k is summed (``csrc/dma_blend.cu``)

The rows are the JAX script's: orbiting sources (0.4 + 0.01 i s, 5 degrees,
r = 1), 33 extended rows each (the first old row and 32 new ones), the
table from seed 0.  Timing: ``bench.time_ms`` (CUDA events, median of 7
runs of 20 calls), beside the JAX script's effective GB/s and the bound of
the blend (its output written once, the table rows it names, the ids and
weights read once, at 3.35 TB/s).  Nothing is timed on the CPU.

    python -m jefferson_tpu_torch.scripts.bench_blend_variants [R] [TB] [--device cuda]

Prints one line per variant; ``main`` returns the numbers as a dict, with
``kernel_vs_twin``: the kernel against its plain twin on the same operands.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import bench
from ..config import DEFAULT_CONFIG
from ..engine.plan import make_plan
from ..engine.renderer import resolve_device
from ..hrtf.kemar import AZIMUTH_COUNTS, AZIMUTH_OFFSET, NUM_ELEV, NUM_HRTF
from ..kernels.dma_blend import dma_blend, dma_blend_reference
from ..trajectory.trajectory import CircularOrbit


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def xla16(planes, idx, w):
    outs = []
    for t in planes:  # 4 planes, 4 gathers each
        acc = w[:, 0:1] * torch.index_select(t, 0, idx[:, 0])
        for k in range(1, 4):
            acc = acc + w[:, k : k + 1] * torch.index_select(t, 0, idx[:, k])
        outs.append(acc)
    return torch.cat(outs, dim=1)


def xla4(table, idx, w):
    acc = w[:, 0:1] * torch.index_select(table, 0, idx[:, 0])
    for k in range(1, 4):
        acc = acc + w[:, k : k + 1] * torch.index_select(table, 0, idx[:, k])
    return acc


def xla2pair(pair_table, pid0, pid2, w, c: int):
    r0 = torch.index_select(pair_table, 0, pid0)  # (R, 2C)
    r2 = torch.index_select(pair_table, 0, pid2)
    acc = w[:, 0:1] * r0[:, :c]
    acc = acc + w[:, 1:2] * r0[:, c:]
    acc = acc + w[:, 2:3] * r2[:, :c]
    acc = acc + w[:, 3:4] * r2[:, c:]
    return acc


def workload(r_rows: int, config=DEFAULT_CONFIG) -> tuple[np.ndarray, np.ndarray]:
    """(idx (R, 4) int32, w (R, 4) float32): orbiting sources, a crossfade
    every block, 33 extended rows per source (the first old row, then the
    32 new ones), cut to ``r_rows``."""
    nb = 32
    n_src = -(-r_rows // (nb + 1))
    rows_i, rows_w = [], []
    for i in range(n_src):
        p = make_plan(CircularOrbit(period_s=0.4 + 0.01 * i, ele=5, r=1.0).sample(nb, config),
                      config)
        rows_i.append(np.concatenate([p.idx_old[:1], p.idx_new]))
        rows_w.append(np.concatenate([p.w_old[:1], p.w_new]))
    return (np.concatenate(rows_i)[:r_rows].astype(np.int32),
            np.concatenate(rows_w)[:r_rows].astype(np.float32))


def tables(config=DEFAULT_CONFIG, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The combined-plane table (710, 4*bins) drawn from ``seed``, and the
    same with its rows padded with zeros to a multiple of 128 floats."""
    c = 4 * config.num_bins
    table = np.random.default_rng(seed).standard_normal((NUM_HRTF, c)).astype(np.float32)
    table_pad = np.zeros((NUM_HRTF, _round_up(c, 128)), np.float32)
    table_pad[:, :c] = table
    return table, table_pad


def successor() -> np.ndarray:
    """Each filter's next azimuth on its elevation ring, wrapping."""
    succ = np.empty(NUM_HRTF, np.int32)
    for e in range(NUM_ELEV):
        o, n = AZIMUTH_OFFSET[e], AZIMUTH_COUNTS[e]
        succ[o : o + n] = o + (np.arange(n) + 1) % n
    return succ


def pair_operands(table_np: np.ndarray, idx: np.ndarray):
    """(pair table (2H, 2C), pid0, pid2) of the xla2pair variant, built as
    the JAX script builds them; raises if a bracket pair is not a filter
    and itself or its successor."""
    succ = successor()
    pair = np.concatenate([
        np.concatenate([table_np, table_np[succ]], axis=1),
        np.concatenate([table_np, table_np], axis=1),
    ])
    same01 = idx[:, 1] == idx[:, 0]
    same23 = idx[:, 3] == idx[:, 2]
    if not (np.all(same01 | (idx[:, 1] == succ[idx[:, 0]]))
            and np.all(same23 | (idx[:, 3] == succ[idx[:, 2]]))):
        raise ValueError("a bracket pair is not a filter and itself or its successor")
    pid0 = (idx[:, 0] + NUM_HRTF * same01).astype(np.int32)
    pid2 = (idx[:, 2] + NUM_HRTF * same23).astype(np.int32)
    return pair, pid0, pid2


def work(idx: np.ndarray, c_pad: int) -> tuple[float, int]:
    """(fp32 operations, least bytes) of the blend of ``idx``'s rows: four
    multiplies and three adds per output; its output written once, the
    table rows the ids name, the ids and the weights read once."""
    r_rows = len(idx)
    named = len(np.unique(idx))
    return 7.0 * r_rows * c_pad, (r_rows + named) * c_pad * 4 + 2 * idx.size * 4


def run(device, r_rows: int = 8448, tb: int = 256) -> dict:
    """Every variant on ``device``; prints each line and returns the
    numbers (ms only on a CUDA device)."""
    cfg = DEFAULT_CONFIG
    bins = cfg.num_bins
    table_np, table_pad = tables(cfg)
    c, c_pad = table_np.shape[1], table_pad.shape[1]
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"device: {name}  R={r_rows} C={c} (pad {c_pad}) TB={tb}", file=sys.stderr)

    idx, w = workload(r_rows, cfg)
    pair, pid0, pid2 = pair_operands(table_np, idx)

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    planes = tuple(put(table_np[:, j * bins : (j + 1) * bins]) for j in range(4))
    table, table_flat, pair_d = put(table_np), put(table_pad.reshape(-1)), put(pair)
    idx_d, w_d, pid0_d, pid2_d = map(put, (idx, w, pid0, pid2))

    fns = {
        "xla16": lambda: xla16(planes, idx_d, w_d),
        "xla4": lambda: xla4(table, idx_d, w_d),
        "xla2pair": lambda: xla2pair(pair_d, pid0_d, pid2_d, w_d, c),
        "kernel": lambda: dma_blend(table_flat, idx_d, w_d, c_pad, tb=tb),
    }
    bound = bench.bound_ms(*work(idx, c_pad)) if cuda else None
    res = {"device": name, "rows": r_rows, "c_pad": c_pad, "named_rows": len(np.unique(idx)),
           "bound_ms": None if bound is None else bound[0], "variants": {}}
    outs = {}
    for vname, fn in fns.items():
        out = fn()
        if vname == "kernel":
            twin = dma_blend_reference(table_flat, idx_d, w_d, c_pad, tb=tb)
            res["kernel_vs_twin"] = {"max_abs": float((out - twin).abs().max()),
                                     "bit_identical": torch.equal(out, twin)}
        outs[vname] = out[:, :c].cpu().numpy()
        ms = bench.time_ms(fn) if cuda else None
        entry = {"ms": ms}
        if ms is None:
            print(f"{vname}: not timed on the CPU", file=sys.stderr)
        else:
            entry["gbps"] = (r_rows * 4 * c * 4 + r_rows * c * 4) / (ms * 1e-3) / 1e9
            print(f"{vname}: {ms:.4f} ms  (~{entry['gbps']:.0f} GB/s effective; bound "
                  f"{bound[0]:.4f} ms, {bound[1]})  [{bench.card()}]", file=sys.stderr)
        res["variants"][vname] = entry
    for vname, o in outs.items():
        same = bool(np.array_equal(o.view(np.int32), outs["xla16"].view(np.int32)))
        res["variants"][vname]["bit_identical_to_xla16"] = same
        if vname != "xla16":
            print(f"{vname} bit-identical to xla16: {same}", file=sys.stderr)
    if cuda:
        best = min(res["variants"], key=lambda v: res["variants"][v]["ms"])
        res["best"] = best
        print(f"best: {best} at {res['variants'][best]['ms']:.4f} ms", file=sys.stderr)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", type=int, default=8448, help="rows R (256 sources x 33)")
    ap.add_argument("tb", nargs="?", type=int, default=256, help="the TPU tile: must divide R")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device), args.rows, args.tb)


if __name__ == "__main__":
    main()
