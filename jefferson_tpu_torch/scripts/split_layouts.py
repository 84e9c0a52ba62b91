"""Launch B's split form on the card: held torch.equal to launch B (one
CTA per 32 rows) and timed beside it and the plain twin, for rows 2-8 at
their main path's shapes, and its crossover against launch B over a range
of row counts, read in turns.

The split form (``csrc/fused_forward.cuh``) takes, for each kind of row,
the layout ``kernels/fused_step.split_default`` names, fixed when a
geometry's library is built: chunked (a CTA per t-tile of 128 columns and
128-bin block, q built a 32-bin chunk at a time) or pipelined (a CTA per
block walking every t-tile, q built once, the basis one stream of chunks,
the fold by warps of its own), with launch B's bits.  The wrappers take
launch B or the split form by ``pick_form``; this script names each
through the wrappers' private seams (``fused_step._cuda``,
``fused_spatializer._cuda``).

    python -m jefferson_tpu_torch.scripts.split_layouts [--geometry f2048 ...]
        [--kernels NAME ...] [--cross 8 64 ...] [--repeat 2]

Geometries by name (``GEOMETRIES``: fpb, HRIR taps, chip_smoke.py's phase
geometry and fpb 128 / pad 1024) and the shapes of that phase: rows 3-5 at
1 x 2,048 rows, rows 2 and 6 at 16 x 256, row 7 at 16 x 512, row 8 at
4,096.  Times: device time alone (the calls queued behind a stream held by
a spin kernel, then CUDA events around them), CUDA events per call
(``bench.time_ms``), the twin's events, and the bound (``bench.bound_ms``).
At each crossover count the two forms are read ``--repeat`` times in turns
(launch B first, then the split form first, ...); a form wins a count
where its mean is less by more than either form's spread between readings
and than ``RUN_SPREAD`` (a reading's spread between chip runs) and no
reading of the two overlaps, else the count is "within spread".
Prints a line per kernel and geometry and, last, the numbers as one JSON
object; ``measure`` returns them.  It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import bench
from ..config import EngineConfig
from ..hrtf.kemar import synthetic_database
from ..kernels import fused_apply as fa
from ..kernels import fused_spatializer as fsp
from ..kernels import fused_step as fs

GEOMETRIES = {
    "f128": (128, 512), "f64": (64, 512), "f256": (256, 512), "f512": (512, 512),
    "f1024": (1024, 512), "f64t256": (64, 256), "f100": (100, 512), "f441": (441, 512),
    "f16": (16, 512), "f4": (4, 512), "f2048": (2048, 512), "f128t2048": (128, 2048),
}
CROSS_ROWS = (8, 64, 256, 512, 1024, 2048, 3072, 4096, 6144, 8192, 16384)
WITHIN = "within spread"
# A reading's largest spread between chip runs: 5.4% over 140 readings of
# rows 5-8 at 8-16,384 rows at f2048, f128t2048, f441 and f1024, each read
# in four to six runs on an H100 (PERF.md, PR 17).  A form takes a count
# only where it took less by more than this.
RUN_SPREAD = 0.055
# kernel -> its step's main-path rows (chip_smoke.py's phase geometry)
MAIN_ROWS = {
    fs.GROUPED: 4096, "fused_step_stream_onehot_xfade": 2048,
    "fused_step_stream_onehot_grouped_xfade": 2048, "fused_step_stream_xfade": 2048,
    fs.NO_XFADE: 2048, "fused_step_xfade": 4096, "fused_step_xfade/no_xfade": 4096,
    "fused_apply_xfade": 8192, fa.NO_XFADE: 8192, fs.SPATIALIZER: 4096,
}
_STREAM = {"fused_step_stream_onehot_xfade": "onehot",
           "fused_step_stream_onehot_grouped_xfade": "grouped",
           "fused_step_stream_xfade": "gather", fs.NO_XFADE: "gather_noxf"}
_SCENE = {fs.GROUPED: "grouped", "fused_step_xfade": "gather",
          "fused_step_xfade/no_xfade": "gather_noxf", "fused_apply_xfade": "apply",
          fa.NO_XFADE: "apply_noxf"}
GROUP_TB, GROUP_TILES = 256, 2   # row 4's groups, as chip_smoke.py's


def step(db, name: str, rows: int, device):
    """Kernel ``name``'s operands at ``rows`` rows -> (call(form), twin(),
    (sources, blocks), bytes): ``call`` runs the wrapper with launch B in
    ``form``; bytes are the operands' and the output's (row 8: of the table,
    the rows its brackets name), each once."""
    cfg = db.config
    geo = dict(pad_len=cfg.pad_len, bins=cfg.num_bins, fpb=cfg.frames_per_buffer)
    if name == fs.SPATIALIZER:
        table, fwd, br, xf = bench.spatializer_step(db, rows, device)
        if cfg.pad_len % cfg.frames_per_buffer == 0:
            xd = fs._forward_reference(fwd[0][None], rows, *fwd[1:], None, None, **geo)
        else:
            from ..engine.stream import _window_xd

            xd = _window_xd(fwd[0].unfold(0, cfg.pad_len, cfg.frames_per_buffer), *fwd[1:], cfg)
        ids = torch.cat([br[0], br[2]]).unique().numel()
        moved = (_nbytes(*xd, *br, xf) + ids * table.shape[1] * 4
                 + rows * 2 * cfg.frames_per_buffer * 4)
        return (lambda f: fsp._cuda(device, rows, table, br, xf, *xd, None, form=f, **geo),
                lambda: fsp.fused_apply_reference(table, *xd, *br, xf, bins=geo["bins"],
                                                  fpb=geo["fpb"]), (1, rows), moved)
    if name in _STREAM:
        tb = min(GROUP_TB, rows)
        gt = GROUP_TILES if rows >= GROUP_TB * GROUP_TILES else 1
        fn, args, kw = bench.stream_step(db, _STREAM[name], rows, device, tb=tb, group_tiles=gt,
                                         xf_every=7)
        s = 1
    else:
        s = max(1, rows // (512 if name.startswith("fused_apply") else 256))
        form = _SCENE[name]
        groups = {"group_sources": 1 if s < 4 else 4} if form == "grouped" else {}
        fn, args, kw = bench.scene_step(db, form, s, rows // s, device, xf_every=7, **groups)
    twin = getattr(sys.modules[fn.__module__], fn.__name__ + "_reference")
    moved = _nbytes(*args, *kw.values()) + rows * 2 * cfg.frames_per_buffer * 4
    return (lambda f: fs._cuda(fn, *args, form=f, **kw), lambda: twin(*args, **kw),
            (s, rows // s), moved)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def device_ms(call, reps: int = 5) -> float:
    """Device ms per call of ``call()`` with no host time in it: the stream
    is held by a spin kernel while ``reps`` calls queue, then CUDA events
    time them back to back."""
    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)    # about 25 ms: far longer than the host takes to queue
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def verdict(b_ms: list[float], s_ms: list[float]) -> str:
    """The form that took less at one count, from readings of launch B
    (``b_ms``) and the split form (``s_ms``): its mean less by more than
    either form's spread between these readings and than RUN_SPREAD of the
    larger mean, no reading overlapping; else WITHIN."""
    b_mean, s_mean = sum(b_ms) / len(b_ms), sum(s_ms) / len(s_ms)
    spread = max(max(b_ms) - min(b_ms), max(s_ms) - min(s_ms), RUN_SPREAD * max(b_mean, s_mean))
    if s_mean - b_mean > spread and max(b_ms) < min(s_ms):
        return fs.LAUNCH_B
    if b_mean - s_mean > spread and max(s_ms) < min(b_ms):
        return fs.SPLIT
    return WITHIN


def measure(name: str, kernels=None, cross=CROSS_ROWS, repeat: int = 1, device="cuda",
            db=None) -> dict:
    """Geometry ``name``'s split form: {"fpb", "pad", "kernels": {kernel:
    {"rows", "layout", "equal", "alone": {form: ms}, "ms", "launch_b_ms",
    "plain_ms", "bound_ms", "bound_by", "max_abs_err_launch_b", "cross":
    {rows: {form: [ms, ...], "took_less": form or WITHIN}}, "pick_differs":
    [rows]}}} for ``kernels`` (default every kernel of rows 2-8 the geometry
    runs), on ``db`` (default the geometry's synthetic database), with each
    kernel's crossover at the row counts ``cross`` read ``repeat`` times in
    turns (none when empty); "pick_differs" names the counts at which the
    wrappers' pick (``pick_form``) is the form that took more."""
    if not torch.cuda.is_available():
        raise RuntimeError("split_layouts needs a CUDA device")
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    fpb, taps = GEOMETRIES[name]
    cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
    db = db if db is not None else synthetic_database(cfg)
    pad, bins = cfg.pad_len, cfg.num_bins
    forms = fs.geometry_forms(fpb, pad)
    if not forms.split:
        raise ValueError(f"{name}: the split form does not exist at fpb {fpb}, pad {pad}")
    kernels = kernels or [k for k in MAIN_ROWS if forms.q or k.startswith(("fused_apply",
                                                                          fs.SPATIALIZER))]
    out = {"fpb": fpb, "pad": pad, "kernels": {}}
    both = (fs.LAUNCH_B, fs.SPLIT)
    for kernel in kernels:
        layout = fs.split_default(kernel, fpb)
        rows = MAIN_ROWS[kernel]
        call, twin, (s, nb), moved = step(db, kernel, rows, device)
        want = call(fs.LAUNCH_B)
        equal = torch.equal(call(fs.SPLIT), want)
        alone = {f: device_ms(lambda: call(f)) for f in both}
        err = float((want - twin()).abs().max())
        ms = bench.time_ms(lambda: call(fs.SPLIT), reps=5, rounds=3)
        b_ms = bench.time_ms(lambda: call(fs.LAUNCH_B), reps=5, rounds=3)
        plain_ms = bench.time_ms(twin, reps=1, rounds=3, warmup=1)
        bound, by = bench.bound_ms(bench.step_flops(kernel, s, nb, fpb, bins, max(forms.q, 1)),
                                   moved)
        got = {"rows": rows, "layout": layout, "equal": equal, "alone": alone, "ms": ms,
               "launch_b_ms": b_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "max_abs_err_launch_b": err}
        print(f"{name} {kernel} at {rows} rows: device time alone launch B "
              f"{alone[fs.LAUNCH_B]:.4f}, split ({layout}) {alone[fs.SPLIT]:.4f} ms; events: "
              f"split {ms:.4f}, launch B {b_ms:.4f}, twin {plain_ms:.4f}; bound {bound:.4f} ms "
              f"({by}); torch.equal to launch B: {equal}  [{bench.card()}]", flush=True)
        if cross:
            got["cross"] = {}
            for r in cross:
                c = step(db, kernel, r, device)[0]
                took = {f: [] for f in both}
                for i in range(repeat):   # in turns: launch B first, then the split form first
                    for f in (both if i % 2 == 0 else both[::-1]):
                        took[f].append(device_ms(lambda: c(f), reps=3))
                took["took_less"] = verdict(took[fs.LAUNCH_B], took[fs.SPLIT])
                got["cross"][r] = took
            pick = (lambda r: fsp.pick_form(r, fpb, pad)) if kernel == fs.SPATIALIZER else (
                lambda r: fs.pick_form(kernel, r, fpb, pad))
            got["pick_differs"] = [r for r, t in got["cross"].items()
                                   if t["took_less"] not in (WITHIN, pick(r))]
            print(f"{name} {kernel} crossover, device time alone (launch B / split, {layout}; "
                  f"{repeat} reading(s) in turns): "
                  + ", ".join(f"{r}: " + " ".join(f"{b:.4f}/{p:.4f}" for b, p in
                                                  zip(t[fs.LAUNCH_B], t[fs.SPLIT]))
                              + f" {t['took_less']}" for r, t in got["cross"].items())
                  + f" ms; pick_form takes the form that took more at {got['pick_differs']}"
                    f"  [{bench.card()}]", flush=True)
        out["kernels"][kernel] = got
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--geometry", nargs="*", default=[g for g in GEOMETRIES if g != "f128"],
                   choices=list(GEOMETRIES))
    p.add_argument("--kernels", nargs="*", default=None, choices=list(MAIN_ROWS))
    p.add_argument("--cross", nargs="*", type=int, default=list(CROSS_ROWS),
                   help="the crossover's row counts (none: skip it)")
    p.add_argument("--repeat", type=int, default=1, help="readings of each count, in turns")
    args = p.parse_args(argv)
    res = {}
    for g in args.geometry:
        cfg = EngineConfig(frames_per_buffer=GEOMETRIES[g][0], hrtf_len=GEOMETRIES[g][1])
        forms = fs.geometry_forms(cfg.frames_per_buffer, cfg.pad_len)
        kernels = [k for k in args.kernels or MAIN_ROWS
                   if forms.q or k.startswith(("fused_apply", fs.SPATIALIZER))]
        res[g] = measure(g, kernels=kernels, cross=args.cross, repeat=args.repeat)
    bad = [(g, k) for g, r in res.items() for k, v in r["kernels"].items() if not v["equal"]]
    print(json.dumps({"card": bench.card(), "geometries": res}, default=str))
    if bad:
        print(f"the split form not torch.equal to launch B: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
