"""Launch B's device time alone, rows 1-8, in every form a geometry's
library has, at the shapes of chip_smoke.py's phase geometry, and launch A
alone in the form the steps take: a change to launch A or B runs this on
the parent's checkout and on its own in one call, in turns, and compares
the readings.

    PYTHONPATH=<checkout> python jefferson_tpu_torch/scripts/tail_times.py
        [--geometry f64 f64t256 f16 f4 f128] [--readings 3] [--launch-a-forms]

Run it as a file, with the checkout to time first on PYTHONPATH: it
imports ``jefferson_tpu_torch`` from there (its ``scripts.split_layouts``
gives rows 2-8's operands).  Rows 2-8 at split_layouts' main shapes (rows
3-5 1 x 2,048, rows 2 and 6 16 x 256, row 7 16 x 512, row 8 4,096 rows
and the live block's one row;
rows 2-6 with launch A, as their wrappers run it), in launch B and in the
split form where it exists; row 1 at 16 sources x 64 blocks (compact
distance): the whole step, launch A alone in the form the step takes, and
launch B as the difference; launch A alone at 16 x 256, 16 x 64, 1 x
2,048 and 1 x 1 (per-row distance), in the form the checkout's
``forward_form`` names.  With ``--launch-a-forms`` it times launch A
alone at those four shapes in each of the ring and planes forms the
library has, and nothing else: the readings that set where the steps take
the ring form (``fused_step.forward_form``).  Each geometry's line names
the layout of launch B's split form its libraries report and, where the
checkout has ``fused_step.split_occupancy``, the clusters the card holds
at once and the SMs they cover.  ``--library`` also reads, for rows 5-8,
the tail product alone as one PyTorch call (``tail_product_ms``).  A
geometry is a name of
split_layouts' ``GEOMETRIES`` or ``f<fpb>t<taps>`` (``f<fpb>``: 512 taps);
the libraries of every geometry asked are built first, all at once.  Each number is the median of ``--readings``
readings of device time alone (10 calls queued behind a stream held by a
spin kernel, then CUDA events around them).  Prints one JSON line.  It
needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys


# launch A's shapes: the scene step's, row 1's, row 5's and the live block
LAUNCH_A_SHAPES = ((16, 256), (16, 64), (1, 2048), (1, 1))
# rows 5-8's kernels (crossfading: two sides), whose tail product the
# library yardstick times at split_layouts' main shapes
LIBRARY_ROWS = ("fused_step_stream_xfade", "fused_step_xfade", "fused_apply_xfade",
                "fused_spatializer_apply")


def tail_product_ms(rows: int, sides: int, bins: int, fpb: int, device, timer) -> float:
    """The tail product alone (no q build, blend or epilogue) as one
    PyTorch call, the library yardstick of launch B: ``torch.matmul`` in
    fp32 with TF32 off of the rows' q planes ``[qr | qi]`` ((sides * 2 *
    rows) x 2 bins) by ``[icr ; ici]`` (2 bins x fpb), on random operands;
    ``timer(call)`` reads its device ms."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(sides * 2 * rows, 2 * bins, device=device, generator=g)
    b = torch.randn(2 * bins, fpb, device=device, generator=g)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return timer(lambda: torch.matmul(a, b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def geometry(name: str) -> tuple[int, int]:
    """(fpb, HRIR taps) of ``name``: an entry of split_layouts' GEOMETRIES,
    else ``f<fpb>t<taps>`` or ``f<fpb>`` (512 taps)."""
    from jefferson_tpu_torch.scripts import split_layouts as sl

    if name in sl.GEOMETRIES:
        return sl.GEOMETRIES[name]
    m = re.fullmatch(r"f(\d+)(?:t(\d+))?", name)
    if m is None:
        raise ValueError(f"geometry {name!r}: want one of {sorted(sl.GEOMETRIES)} or f<fpb>t<taps>")
    return int(m[1]), int(m[2] or 512)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--geometry", nargs="*", default=["f64", "f64t256", "f16", "f4", "f128"])
    p.add_argument("--readings", type=int, default=3)
    p.add_argument("--launch-a-forms", action="store_true",
                   help="launch A alone in its ring and planes forms, nothing else")
    p.add_argument("--library", action="store_true",
                   help="also rows 5-8's tail product as one torch.matmul")
    args = p.parse_args(argv)
    geos = {name: geometry(name) for name in args.geometry}

    import torch

    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.config import EngineConfig
    from jefferson_tpu_torch.hrtf.kemar import synthetic_database
    from jefferson_tpu_torch.kernels import build
    from jefferson_tpu_torch.kernels import fused_step as fs
    from jefferson_tpu_torch.scripts import split_layouts as sl

    if not torch.cuda.is_available():
        raise RuntimeError("tail_times needs a CUDA device")
    configs = {name: EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
               for name, (fpb, taps) in geos.items()}
    build.build_all(["fused_step_onehot"] + ([] if args.launch_a_forms else ["fused_step_gather"]),
                    geometries=[(c.frames_per_buffer, c.pad_len) for c in configs.values()])
    device = torch.device("cuda", torch.cuda.current_device())
    alone = lambda call: statistics.median(sl.device_ms(call, reps=10)
                                           for _ in range(args.readings))
    out = {}
    for name, cfg in configs.items():
        fpb, pad, bins = cfg.frames_per_buffer, cfg.pad_len, cfg.num_bins
        forms = fs.geometry_forms(fpb, pad)
        got = {}
        if args.launch_a_forms:
            a_forms = [fs.FWD_RING] * forms.ring + [fs.FWD_PLANES] * bool(forms.q)
            for s_, nb in LAUNCH_A_SHAPES:
                ops = bench.forward_operands(s_, nb, device, seed=7, config=cfg)
                got[f"launch A {s_}x{nb}"] = {f: alone(
                    lambda: fs._forward_cuda(*ops, form=f, pad_len=pad, bins=bins, fpb=fpb))
                    for f in a_forms}
                del ops
            out[name] = got
            print(f"{name} (pad {pad}, Q {forms.q}): " + "; ".join(
                f"{k} " + " ".join(f"{f} {ms:.4f}" for f, ms in v.items()) for k, v in got.items())
                  + f" ms  [{bench.card()}]", file=sys.stderr, flush=True)
            continue
        db = synthetic_database(cfg)
        tail = [fs.LAUNCH_B] + ([fs.SPLIT] if forms.split else [])
        if forms.split:
            for lib in ("fused_step_onehot", "fused_step_gather"):
                what = getattr(fs.library_geometry(lib, fpb, pad), "layouts", None)
                occ = (fs.split_occupancy(lib, fpb, pad) if hasattr(fs, "split_occupancy")
                       else {})
                got[f"split form, {lib}"] = {"layouts": what, **occ}
        for kernel in sl.MAIN_ROWS:
            if not (forms.q or kernel.startswith(("fused_apply", fs.SPATIALIZER))):
                continue
            call = sl.step(db, kernel, sl.MAIN_ROWS[kernel], device)[0]
            got[kernel] = {f: alone(lambda: call(f)) for f in tail}
            if kernel == fs.SPATIALIZER:   # the live block's one row
                one = sl.step(db, kernel, 1, device)[0]
                got[f"{kernel}, 1 row"] = {f: alone(lambda: one(f)) for f in tail}
            if args.library and kernel in LIBRARY_ROWS:
                got[kernel]["library"] = tail_product_ms(sl.MAIN_ROWS[kernel], 2, bins, fpb,
                                                         device, alone)
        if forms.q:
            a, kw = bench.step_operands(bench.build_workload(db, 16, 64, device), cfg)
            step = lambda: fs.fused_step_onehot_xfade(*a, **kw)
            fwd = (a[0], kw["nb"], *a[1:4], kw.get("dsel"), kw.get("n_dist"))
            a_form = fs.forward_form(kw["nb"], fpb, pad, a[0].shape[0] if a[0].dim() == 2 else 1)
            whole = alone(step)
            launch_a = alone(lambda: fs._forward_cuda(*fwd, form=a_form, pad_len=pad,
                                                      bins=bins, fpb=fpb))
            got[fs.ROW1] = {"step": whole, "launch A": launch_a, "launch_b": whole - launch_a}
            for s_, nb in LAUNCH_A_SHAPES:
                ops = bench.forward_operands(s_, nb, device, seed=7, config=cfg)
                form = fs.forward_form(nb, fpb, pad, s_)
                got[f"launch A {s_}x{nb}"] = {form: alone(
                    lambda: fs._forward_cuda(*ops, form=form, pad_len=pad, bins=bins, fpb=fpb))}
        out[name] = got
        print(f"{name}: " + "; ".join(
            f"{k} " + " ".join(f"{f} {ms:.4f}" if isinstance(ms, float) else f"{f} {ms}"
                               for f, ms in v.items()) for k, v in got.items())
              + f" ms  [{bench.card()}]", file=sys.stderr, flush=True)
    print(json.dumps({"card": bench.card(), "geometries": out}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
