"""Benchmark of the port: sustained 128-sample blocks/s on one CUDA device.

The workload is the JAX package's ``bench.py`` workload: 256 concurrent
moving sources (circular orbits, crossfade on every block), 64 blocks per
step, overlap-save history carried from step to step, through the batched
one-hot fused step with one compact table and compact distance.

Timing: CUDA events around 20 steps in a row after warm-up, divided by 20;
the result is the median of 7 such runs.  The fused step alone is also timed through
the CUDA kernel and through its plain-PyTorch twin on the same operands.
Parity: one fresh step's source 0 against ``render_oracle``; RMS must stay
under 1e-4, else this raises.

    python -m jefferson_tpu_torch.bench --device cuda

(``bench/__main__.py``; the sweep gate is ``bench/sweep.py``.)

Prints ONE JSON line to stdout (metric, value, unit, vs_baseline); the
step, kernel and twin times, the card and its power limit, and the device
time of each launch per step (torch.profiler over 10 carried steps, with
the device's idle share) go to stderr.
``vs_baseline`` is against the original CUDA engine's ~0.3 ms per block
(3,333 blocks/s, BASELINE.md).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..convert import spectra_from_numpy
from ..engine.batch import (
    _group_bucket, _plan_batch_onehot, batched_chunk_fn_fused, group_tile, onehot_step_operands,
)
from ..engine.plan import (
    compact_filter_ids, compact_filter_ids_grouped, compact_filter_ids_grouped_sources, make_plan,
)
from ..engine.renderer import cat_table, dedup_distance, pick_fused_tile
from ..hrtf.kemar import (
    AZIMUTH_GRIDS, AZIMUTH_OFFSET, ELEVATIONS, NUM_ELEV, round_half_away, synthetic_database,
)
from ..io.wavio import write_wav
from ..kernels import fused_apply, fused_spatializer, fused_step
from ..kernels.fused_step import blend_cat
from ..ops import fft as fft_ops
from ..ops.filters import cmul, distance_factors_split, distance_phase_split
from ..oracle.reference import render_oracle
from ..trajectory.trajectory import CircularOrbit
from .sweep import (  # noqa: F401  (the bench's names since before bench/ was a package)
    mover_positions, scene_hold_positions, scene_mover_positions, scene_signals,
)
from .sweep import sweep_scenario as sweep_positions  # noqa: F401  (a reference scenario)

BASELINE_BLOCKS_PER_S = 3333.3
SOURCES, BLOCKS = 256, 64  # the JAX bench.py workload: sources x blocks per step


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def plain_host():
    """Inside the block, ``make_plan``, the renderers' ``fed_stream`` and
    the live path's new-position set-up take the plain NumPy forms of the
    host library's functions (``_pick_hrtf_numpy``,
    ``_interpolation_calculations_numpy``, ``_distance_phase_split_numpy``,
    ``_fed_stream_numpy``): for holding the library to them and timing the
    host path each way.  The library comes back on exit."""
    from ..engine import batch, plan, renderer, stream
    from ..hrtf import kemar
    from ..ops import filters
    from ..trajectory import interpolation

    swaps = [(plan, "pick_hrtf", kemar._pick_hrtf_numpy),
             *((mod, "interpolation_calculations",
                interpolation._interpolation_calculations_numpy) for mod in (plan, stream)),
             *((mod, "distance_phase_split", filters._distance_phase_split_numpy)
               for mod in (plan, stream)),
             *((mod, "fed_stream", plan._fed_stream_numpy) for mod in (batch, renderer, stream))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@dataclasses.dataclass
class Workload:
    """One step of the bench workload, staged on the device."""

    n_sources: int
    nb: int
    u_pad: int
    n_dist: int | None
    spectra: tuple
    hists: torch.Tensor
    feds: torch.Tensor
    chunk: tuple            # the chunk function's operands after (spectra, hists, feds)
    dsel: torch.Tensor | None
    step: object            # batched_chunk_fn_fused(...)


def orbit(i: int, nb: int, cfg=DEFAULT_CONFIG, radius_step: float = 0.0) -> np.ndarray:
    """Source i's trajectory: a circular orbit at 5° elevation and radius
    1 + i * radius_step (the bench: r = 1 for every source)."""
    return CircularOrbit(period_s=0.4 + 0.01 * i, ele=5, r=1.0 + i * radius_step).sample(nb, cfg)


def moving_scene(n_sources: int, n_blocks: int, cfg=DEFAULT_CONFIG, seed: int = 1):
    """(signals (S, n_blocks*fpb), positions (S, n_blocks, 3)) of a scene
    that ``BatchRenderer`` takes through the shared one-hot step: circular
    orbits at r = 1 whose elevations (1..9 degrees, between the 0 and 10
    degree rings of the HRTF grid) keep each source's (filter, weight) rows
    apart, so the hold-scene dedup declines, while the whole scene touches
    at most the two rings' 144 filters, so one compact table holds them."""
    rng = np.random.default_rng(seed)
    fpb = cfg.frames_per_buffer
    signals = (rng.standard_normal((n_sources, n_blocks * fpb)) * 0.2).astype(np.float32)
    positions = np.stack([
        CircularOrbit(period_s=0.4 + 0.01 * i, ele=1 + i % 9, r=1.0).sample(n_blocks, cfg)
        for i in range(n_sources)
    ])
    return signals, positions


def build_workload(db, n_sources: int, nb: int, device, seed: int = 0,
                   radius_step: float = 0.0) -> Workload:
    """The bench step's inputs, made from ``seed``, on ``device``.  With
    ``radius_step`` > 0 the sources sit at distinct radii, so the step takes
    the per-row distance form instead of the compact one."""
    cfg = db.config
    rng = np.random.default_rng(seed)
    feds = rng.standard_normal((n_sources, nb * cfg.frames_per_buffer)).astype(np.float32) * 0.2
    plans = [make_plan(orbit(i, nb, cfg, radius_step), cfg) for i in range(n_sources)]
    stack = lambda attr: np.stack([getattr(p, attr) for p in plans])
    uniq_ids, ridx, ridx_last, u_pad = compact_filter_ids(
        stack("idx_old"), np.stack([p.idx_new[-1] for p in plans])
    )
    if u_pad > fused_step.MAX_ONEHOT_U:
        raise NotImplementedError(f"{u_pad} unique filters: beyond the shared one-hot form")
    dist = dedup_distance(*(np.concatenate([getattr(p, a) for p in plans])
                            for a in ("u_hi", "u_lo", "inv_frac")))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if dist is None:
        d_args, dsel, nd = tuple(put(stack(a)) for a in ("u_hi", "u_lo", "inv_frac")), None, None
    else:
        d_args, dsel, nd = tuple(put(a) for a in dist[:3]), put(dist[3].reshape(n_sources, nb)), dist[4]
    chunk = (put(uniq_ids), put(ridx), put(stack("w_old")), put(ridx_last),
             put(np.stack([p.w_new[-1] for p in plans])), put(stack("xfade")), *d_args)
    return Workload(
        n_sources=n_sources, nb=nb, u_pad=u_pad, n_dist=nd,
        spectra=spectra_from_numpy(db.spectra, device),
        hists=torch.zeros((n_sources, cfg.history_len), dtype=torch.float32, device=device),
        feds=put(feds), chunk=chunk, dsel=dsel,
        step=batched_chunk_fn_fused(cfg, nb, pick_fused_tile(n_sources * nb, nb), onehot=True,
                                    n_dist=nd),
    )


def helix_positions(num_blocks: int, period_s: float = 0.4, rise_deg: float = 0.5,
                    cfg=DEFAULT_CONFIG) -> np.ndarray:
    """A source circling the listener once per ``period_s`` while rising
    ``rise_deg`` per turn from -10 degrees, r = 1.  Its positions do not
    repeat, so the renderer's dedup declines, while a 2048-block chunk
    stays within one compact table: the single-source one-hot form."""
    i = np.arange(num_blocks)
    turn = period_s * cfg.sample_rate / cfg.frames_per_buffer  # blocks per turn
    return np.stack([(i * 360.0 / turn) % 360.0, -10.0 + rise_deg * i / turn,
                     np.full(num_blocks, 1.0)], axis=1)


def wide_positions(num_sources: int, num_blocks: int, seed: int = 11) -> np.ndarray:
    """(S, B, 3) sources each at a new uniform random position every block
    (azimuth 0-360, elevation -40-90 degrees, r = 1; the JAX package's
    tests/test_batch_parallel.py:629-642): no position repeats and no group
    of sources fits one compact table, so the JAX BatchRenderer takes the
    gather step."""
    rng = np.random.default_rng(seed)
    return np.stack([
        np.stack([rng.uniform(0, 360, num_blocks), rng.uniform(-40, 90, num_blocks),
                  np.full(num_blocks, 1.0)], axis=1)
        for _ in range(num_sources)
    ]).astype(np.float32)


STREAM_FORMS = ("onehot", "grouped", "gather", "gather_noxf")


def write_compact_tree(db, root) -> "Path":
    """``db``'s filters as a compact KEMAR tree under ``root`` (the layout
    ``hrtf.kemar.load_compact`` reads): one stereo float32 WAV per named
    azimuth, H{ele}e{azi:03d}a.wav.  A direction at or below 180 degrees
    writes its own filter; a name only a direction above 180 uses gets
    that direction's filter with the ears swapped, as the loader mirrors
    it back.  Returns ``root``."""
    from pathlib import Path

    root = Path(root)
    taps = db.hrirs[:, :, : db.config.hrtf_len]
    for i in range(NUM_ELEV):
        ele = int(ELEVATIONS[i])
        (root / f"elev{ele}").mkdir(parents=True, exist_ok=True)
        written = set()
        for j, azi in enumerate(AZIMUTH_GRIDS[i]):
            a = float(azi)
            swap = a > 180.0
            name = int(round_half_away(360.0 - a if swap else a))
            if name in written:
                continue
            written.add(name)
            pair = taps[AZIMUTH_OFFSET[i] + j]
            write_wav(root / f"elev{ele}" / f"H{ele}e{name:03d}a.wav",
                      (pair[::-1] if swap else pair).T, db.config.sample_rate,
                      bits=32, float_format=True)
    return root


def stream_step(db, form: str, b: int, device, *, seed: int = 0, radius_step: float = 0.0,
                tb: int | None = None, group_tiles: int | None = None, xf_every: int = 0,
                trajectory: str | None = None):
    """One single-stream step's operands, made from ``seed`` -> (wrapper,
    args, kwargs): ``wrapper(*args, **kwargs)`` runs the step and the
    wrapper's twin takes the same operands.

    ``form``: "onehot" (row 3), "grouped" (row 4, tables per ``group_tiles``
    tiles of ``tb`` blocks), "gather" and "gather_noxf" (row 5 with and
    without the crossfade; the latter takes the plan's new rows).
    ``trajectory``: "orbit" (a circular orbit at 5 degrees, r = 1: compact
    distance), "mover" (``mover_positions``: wide filter sets, per-row
    distance), or "hold" (a fixed position, no crossfade: then "gather" and
    "gather_noxf" on one seed are the no-crossfade contract's pair, the same
    output bit for bit); default "mover" for "grouped", else "orbit".
    ``radius_step`` > 0 moves the radius every block (per-row distance);
    ``xf_every`` > 0 turns the crossfade off on every that-many-th row."""
    cfg = db.config
    fpb = cfg.frames_per_buffer
    rng = np.random.default_rng(seed)
    trajectory = trajectory or ("mover" if form == "grouped" else "orbit")
    if trajectory == "mover":
        pos = mover_positions(b)
    elif trajectory == "hold":
        pos = np.tile([40.0, 10.0, 1.0], (b, 1))
    else:
        pos = CircularOrbit(period_s=0.4, ele=5, r=1.0).sample(b, cfg)
    if radius_step:
        pos[:, 2] = 1.0 + radius_step * np.arange(b)
    plan = make_plan(pos, cfg, initial_old=None if trajectory == "hold" else (0.0, 0.0))
    stream = np.concatenate([(rng.standard_normal(cfg.history_len) * 0.2),
                             rng.standard_normal(b * fpb) * 0.2]).astype(np.float32)
    xf = plan.xfade.astype(np.float32)[:, None]
    if xf_every:
        xf[::xf_every] = 0.0
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    dist = dedup_distance(plan.u_hi, plan.u_lo, plan.inv_frac)
    if dist is None:
        d_args = tuple(put(getattr(plan, a)[:, None]) for a in ("u_hi", "u_lo", "inv_frac"))
        kw = {}
    else:
        d_args = tuple(put(a[:, None]) for a in dist[:3])
        kw = dict(dsel=put(dist[3][:, None]), n_dist=dist[4])
    kw.update(pad_len=cfg.pad_len, bins=cfg.num_bins, fpb=fpb)
    cat = cat_table(spectra_from_numpy(db.spectra, device))
    last_i, last_w = plan.idx_new[-1:], plan.w_new[-1:]
    if form == "onehot":
        uniq, ridx, rlast, _ = compact_filter_ids(plan.idx_old, last_i)
        args = (cat[put(uniq).long()], put(ridx), put(plan.w_old), put(rlast), put(last_w))
        fn = fused_step.fused_step_stream_onehot_xfade
    elif form == "grouped":
        u_pad = 8
        while True:  # the smallest bucket that holds every group's filters
            try:
                uniq, ridx, rbnd = compact_filter_ids_grouped(
                    plan.idx_old, last_i, tb * group_tiles, tb, u_pad)
                break
            except ValueError:
                u_pad *= 2
        wbnd = np.concatenate([plan.w_old[tb::tb], last_w])
        args = (cat[put(uniq).long()], put(ridx), put(plan.w_old), put(rbnd), put(wbnd))
        kw.update(tb=tb, group_tiles=group_tiles, u_pad=u_pad)
        fn = fused_step.fused_step_stream_onehot_grouped_xfade
    elif form == "gather":
        g_old = blend_cat(cat, put(plan.idx_old), put(plan.w_old))
        args = (g_old, blend_cat(cat, put(last_i), put(last_w)))
        fn = fused_step.fused_step_stream_xfade
    elif form == "gather_noxf":
        args = (blend_cat(cat, put(plan.idx_new), put(plan.w_new)), None)
        kw.update(with_xfade=False)
        fn = fused_step.fused_step_stream_xfade
        xf = None
    else:
        raise ValueError(f"form {form!r} not in {STREAM_FORMS}")
    args = (put(stream), *d_args, *args, None if xf is None else put(xf))
    return fn, args, kw


SCENE_FORMS = ("grouped", "gather", "gather_noxf", "apply", "apply_noxf")


def scene_step(db, form: str, s: int, nb: int, device, *, seed: int = 0,
               radius_step: float = 0.0, unit_radius: bool = False,
               trajectory: str | None = None, xf_every: int = 0,
               group_sources: int | None = None, duplicate: bool = False):
    """One batched step of S sources x nb blocks, its operands made from
    ``seed`` -> (wrapper, args, kwargs): ``wrapper(*args, **kwargs)`` runs
    the step and the wrapper's ``_reference`` twin takes the same operands.

    ``form``: "grouped" (row 2, the group plan and tile the batched dispatch
    picks for these positions; with ``group_sources``, groups of that many
    sources in tiles of one source, at any shape), "gather" and
    "gather_noxf" (row 6 with and
    without the crossfade), "apply" and "apply_noxf" (row 7, segments of nb
    rows, its forward planes and distance in plain torch).
    ``trajectory``: "movers" (``scene_mover_positions``, the default for
    "grouped"), "hold" (``scene_hold_positions``, the default otherwise), or
    "still" (the hold scene with no step and no crossfade: then a form and
    its "_noxf" form on one seed are the no-crossfade contract's pair).
    The step takes compact distance where the scene's (u_hi, u_lo,
    inv_frac) triples are few, else per-row distance; the scenes' radii
    give the per-row form, ``unit_radius`` the compact one (each source's
    radius divided by the planner's elevation factor sqrt(1 + sin² ele),
    so every block sits at |coordinates| = 1).  ``radius_step`` > 0 moves
    the radius every block and takes the per-row form at any size.
    ``xf_every`` > 0 turns the crossfade off on every that-many-th row.
    ``duplicate``: each block's brackets are its first id four times at
    weights 1, 0, 0, 0 (a grid position's brackets)."""
    cfg = db.config
    fpb = cfg.frames_per_buffer
    rng = np.random.default_rng(seed)
    trajectory = trajectory or ("movers" if form == "grouped" else "hold")
    if trajectory == "movers":
        pos = scene_mover_positions(s, nb)
    elif trajectory in ("hold", "still"):
        pos = scene_hold_positions(s, nb, blocks_per_step=nb if trajectory == "still" else 172)
    else:
        raise ValueError(f"trajectory {trajectory!r} not in ('movers', 'hold', 'still')")
    if unit_radius:
        ele = np.deg2rad(np.round(pos[:, :, 1]))
        pos[:, :, 2] = 1.0 / np.sqrt(1.0 + np.sin(ele) ** 2)
    if radius_step:
        pos[:, :, 2] += radius_step * np.arange(nb)
    plans = [make_plan(p, cfg, initial_old=None if trajectory == "still" else (0.0, 0.0))
             for p in pos]
    if duplicate:
        for p in plans:
            for ids, ws in (("idx_old", "w_old"), ("idx_new", "w_new")):
                setattr(p, ids, np.repeat(getattr(p, ids)[:, :1], 4, axis=1))
                setattr(p, ws, np.zeros_like(getattr(p, ws)))
                getattr(p, ws)[:, 0] = 1.0
    cat_rows = lambda a: np.concatenate([getattr(p, a) for p in plans])
    last = lambda a: np.stack([getattr(p, a)[-1] for p in plans])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    streams = put((rng.standard_normal((s, cfg.history_len + nb * fpb)) * 0.2).astype(np.float32))
    xf = cat_rows("xfade").astype(np.float32)[:, None]
    if xf_every:
        xf[::xf_every] = 0.0
    xf = put(xf)
    dist = None if radius_step else dedup_distance(cat_rows("u_hi"), cat_rows("u_lo"),
                                                   cat_rows("inv_frac"))
    if dist is None:
        d_args = tuple(put(cat_rows(a)[:, None]) for a in ("u_hi", "u_lo", "inv_frac"))
        kw = {}
    else:
        d_args = tuple(put(a[:, None]) for a in dist[:3])
        kw = dict(dsel=put(dist[3][:, None]), n_dist=dist[4])
    cat = cat_table(spectra_from_numpy(db.spectra, device))
    blend = lambda i, w: blend_cat(cat, put(i), put(w))
    if form == "grouped":
        io = np.stack([p.idx_old for p in plans])
        if group_sources is None:
            plan = _plan_batch_onehot(plans, nb, nb, s)
            tb = None if plan is None or plan[0] != "grouped" else group_tile(s, nb, plan[1])
            if tb is None:
                raise ValueError(f"{trajectory} at {s} x {nb} has no grouped one-hot plan: {plan}")
        else:
            plan = ("grouped", group_sources, _group_bucket(io, last("idx_new"), group_sources))
            tb = nb
        uniq, ridx, rlast = compact_filter_ids_grouped_sources(io, last("idx_new"), *plan[1:])
        args = (streams, *d_args, cat[put(uniq).long()], put(ridx.reshape(-1, 4)),
                put(cat_rows("w_old")), put(rlast), put(last("w_new")), xf)
        kw.update(nb=nb, tb=tb, group_tiles=plan[1] * nb // tb)
        fn = fused_step.fused_step_onehot_xfade
    elif form in ("gather", "gather_noxf"):
        noxf = form == "gather_noxf"
        g = blend(cat_rows("idx_new"), cat_rows("w_new")) if noxf else \
            blend(cat_rows("idx_old"), cat_rows("w_old"))
        args = (streams, *d_args, g, None if noxf else blend(last("idx_new"), last("w_new")),
                None if noxf else xf)
        kw.update(nb=nb, with_xfade=not noxf)
        fn = fused_step.fused_step_xfade
    elif form in ("apply", "apply_noxf"):
        noxf = form == "apply_noxf"
        if cfg.history_len % fpb:  # a history of partial blocks: each window's transform
            xr, xi = fft_ops.rfft_split(streams.unfold(-1, cfg.pad_len, fpb), cfg.pad_len)
        else:
            xr, xi = fft_ops.rfft_sliding_split_batched(streams, nb, fpb, cfg.pad_len)
        dr, di = distance_factors_split(*(put(cat_rows(a)) for a in ("u_hi", "u_lo", "inv_frac")),
                                        cfg.num_bins)
        xdr, xdi = cmul(xr.reshape(s * nb, -1), xi.reshape(s * nb, -1), dr, di)
        g = blend(cat_rows("idx_new"), cat_rows("w_new")) if noxf else \
            blend(cat_rows("idx_old"), cat_rows("w_old"))
        icr, ici = fft_ops.on_device(fft_ops._idft_tail_matrices, cfg.pad_len, fpb, device=device)
        args = (xdr, xdi, g, None if noxf else blend(last("idx_new"), last("w_new")),
                None if noxf else xf, icr, ici)
        return fused_apply.fused_apply_xfade, args, dict(seg=nb, bins=cfg.num_bins, fpb=fpb,
                                                         with_xfade=not noxf)
    else:
        raise ValueError(f"form {form!r} not in {SCENE_FORMS}")
    kw.update(pad_len=cfg.pad_len, bins=cfg.num_bins, fpb=fpb)
    return fn, args, kw


def spatializer_step(db, rows: int, device, *, seed: int = 0, xf_every: int = 7,
                     duplicate: bool = False):
    """Row 8's operands at ``rows`` rows, made from ``seed`` on ``device``
    -> (table, (stream, uh, ul, fr), (idx_old, w_old, idx_new, w_new), xf):
    the full table; one stream of 0.2-std noise and a radius per row in
    0.3-2.0 (the forward form's operands); brackets drawn over the whole
    table with random weights, or with ``duplicate`` one id four times at
    weights 1, 0, 0, 0 on both sides (a grid position's brackets); the
    crossfade on every row but every ``xf_every``-th."""
    cfg = db.config
    rng = np.random.default_rng(seed)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    stream = (rng.standard_normal(cfg.history_len + rows * cfg.frames_per_buffer) * 0.2)
    radii = rng.uniform(0.3, 2.0, rows).astype(np.float32) / np.float32(cfg.distance_scale)
    dist = distance_phase_split(cfg.fsvs, radii, cfg.num_bins)
    if duplicate:
        idx = np.tile(rng.integers(0, db.num_hrtf, (rows, 1)), (1, 4))
        w = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]]), (rows, 1))
        brackets = (idx, w, idx, w)
    else:
        brackets = tuple(f((rows, 4)) for f in (lambda s: rng.integers(0, db.num_hrtf, s),
                                                rng.random) * 2)
    xf = np.ones((rows, 1), np.float32)
    xf[::xf_every] = 0.0
    return (fused_spatializer.kernel_planes(db, device),
            (put(stream.astype(np.float32)), *(put(a[:, None]) for a in dist)),
            tuple(put(a.astype(np.int32 if i % 2 == 0 else np.float32))
                  for i, a in enumerate(brackets)),
            put(xf))


def forward_operands(sources: int, nb: int, device, *, seed: int = 0, n_dist: int | None = None,
                     config=DEFAULT_CONFIG):
    """Launch A's operands for S sources x nb blocks, made from ``seed`` on
    ``device`` -> (streams, nb, uh, ul, fr, dsel, n_dist), the argument
    order of kernels/fused_step._forward_reference: 0.2-std noise, the
    phase split of a radius in 0.3-2.0 per row, or with ``n_dist`` one per
    triple of 8 and a selector a row drawn from -2 .. n_dist + 1, so some
    fall outside 1..n_dist-1 (triple 0)."""
    rng = np.random.default_rng(seed)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    fpb = config.frames_per_buffer
    streams = rng.standard_normal((sources, config.history_len + nb * fpb)) * 0.2
    n_trip = sources * nb if n_dist is None else 8
    radii = rng.uniform(0.3, 2.0, n_trip).astype(np.float32) / np.float32(config.distance_scale)
    dist = distance_phase_split(config.fsvs, radii, config.num_bins)
    dsel = None if n_dist is None else \
        put(rng.integers(-2, n_dist + 2, (sources * nb, 1)).astype(np.int32))
    return (put(streams.astype(np.float32)), nb, *(put(a[:, None]) for a in dist), dsel, n_dist)


# The card's peaks for the bound of a step: fp32 outside the tensor cores
# and HBM bandwidth, from NVIDIA's H100 SXM data sheet (at a 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def forward_flops(sources: int, nb: int, fpb: int = 128, bins: int = 513, q: int = 8) -> float:
    """The fp32 operations of launch A for S sources x nb blocks: one
    128-sample DFT per sub-block (nb + q - 1 a source, re and im), and per
    row and bin the twiddle sum and the distance multiply."""
    return float(sources * (nb + q - 1) * 4 * fpb * bins + sources * nb * bins * (8 * (q - 1) + 6))


# The card's issue rate of fp32 instructions outside the tensor cores: 132
# SMs x 128 lanes x 1.98 GHz (H100 SXM boost clock), half PEAK_FP32_FLOPS,
# which counts an FMA as two operations.
PEAK_FP32_ISSUE = 132 * 128 * 1.98e9


def forward_issue_ms(sources: int, nb: int, bins: int = 513, q: int = 8) -> float:
    """Launch A's issue floor in ms: its twiddle sums' 8 (q - 1) fp32
    operations for each real output (S x nb, no window across two sources)
    and bin, each its own instruction (the JAX op order rounds every
    product and sum on its own: no FMA), over PEAK_FP32_ISSUE.  The table's
    bound (``bound_ms`` of ``forward_flops``) counts them over the FMA rate,
    half this floor."""
    return sources * nb * bins * 8 * (q - 1) / PEAK_FP32_ISSUE * 1e3


def forward_bytes(sources: int, nb: int, fpb: int = 128, bins: int = 513, q: int = 8,
                  n_dist: int | None = None) -> int:
    """The bytes launch A must move: its streams, DFT basis, twiddles and
    distance operands (per row, or n_dist triples and a selector a row)
    read once, its XD planes written once."""
    rows = sources * nb
    dist = 3 * rows * 4 if n_dist is None else 3 * n_dist * 4 + rows * 4
    return 4 * (sources * (nb + q - 1) * fpb + 2 * fpb * bins + 2 * q * bins
                + 2 * rows * bins) + dist


def step_flops(kernel: str, sources: int, nb: int, fpb: int = 128, bins: int = 513,
               q: int = 8) -> float:
    """The fp32 operations a step needs for S sources x nb blocks, counted
    from the code: the sliding forward (one 128-sample DFT per sub-block,
    the twiddle sum and the distance multiply per row), the one-hot blend
    (4 brackets x 4 planes per side), and per side and ear the filter
    multiply and the 513 x 128 tail IDFT.  Rows 7 and 8 (as timed, on the
    caller's XD planes) have no forward, rows 5-7 no blend, and row 8 blends
    both sides from the full table; the no-crossfade forms compute one
    side."""
    rows = sources * nb
    sides = 1 if kernel.endswith("/no_xfade") else 2
    flops = sides * 2 * rows * (6 * bins + 4 * bins * fpb)  # tails
    if not kernel.startswith(("fused_apply", "fused_spatializer")):
        flops += forward_flops(sources, nb, fpb, bins, q)
    if "onehot" in kernel or kernel.startswith("fused_spatializer"):
        flops += sides * rows * 4 * bins * 4 * 2
    return float(flops)


def bound_ms(flops: float, nbytes: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes (each input read once, each output
    written once) over HBM bandwidth -> (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def run_step(wl: Workload, hists=None):
    """One step from ``hists`` (default: the zero history)."""
    h = wl.hists if hists is None else hists
    return wl.step(wl.spectra, h, wl.feds, *wl.chunk, dsel=wl.dsel)


def step_operands(wl: Workload, config=DEFAULT_CONFIG):
    """The fused step's (args, kwargs) for the workload's first step."""
    args, kwargs, _ = onehot_step_operands(
        config, wl.nb, wl.n_dist, wl.spectra, wl.hists, wl.feds, *wl.chunk, dsel=wl.dsel
    )
    return args, kwargs


def parity_rms(wl: Workload, db) -> float:
    """RMS of one fresh step's source 0 against render_oracle."""
    cfg = db.config
    out, _ = run_step(wl)
    got = out[0].cpu().numpy().reshape(wl.nb * cfg.frames_per_buffer, 2)
    want = render_oracle(wl.feds[0].cpu().numpy(), db, [tuple(p) for p in orbit(0, wl.nb, cfg)], cfg)
    return float(np.sqrt(np.mean((got.astype(np.float64) - want) ** 2)))


def time_ms(fn, reps: int = 20, rounds: int = 7, warmup: int = 3) -> float:
    """Device ms per call of ``fn()``: CUDA events around ``reps`` calls in a
    row, divided by ``reps``; the median of ``rounds`` such runs, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def time_steps_ms(wl: Workload) -> float:
    """Device ms per step (``time_ms``), the history carried from step to
    step."""
    h = [wl.hists]

    def step():
        _, h[0] = run_step(wl, h[0])

    return time_ms(step)


def device_profile(fn, calls: int = 1) -> list[tuple[str, float, float]]:
    """Device time by kernel over ``calls`` calls of ``fn()``, from
    torch.profiler: [(kernel, ms per call, launches per call)], largest
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def profile_steps(wl: Workload, steps: int = 10) -> list[tuple[str, float, float]]:
    """Device time by kernel per step over ``steps`` carried steps
    (``device_profile``)."""
    h = [run_step(wl)[1]]

    def step():
        _, h[0] = run_step(wl, h[0])

    return device_profile(step, steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m jefferson_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", required=True, help="a CUDA device, e.g. cuda or cuda:0")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        ap.error("the bench measures a CUDA device")
    with torch.cuda.device(device):
        return run(device)


def run(device) -> int:
    """Parity check, then the timings and the per-kernel profile; prints
    the result line."""
    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    name = torch.cuda.get_device_name(device)
    log(f"device: {name} (nvidia-smi: {card()}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    wl = build_workload(db, SOURCES, BLOCKS, device)
    log(f"{SOURCES} sources x {BLOCKS} blocks per step, compact table U={wl.u_pad}, "
        f"compact distance: {wl.n_dist} triples")
    rms = parity_rms(wl, db)
    log(f"parity (step vs render_oracle, source 0): rms = {rms:.3e} (budget 1e-4)")
    if not rms < 1e-4:
        raise AssertionError(f"bench parity outside budget: rms={rms:.3e}")

    step_ms = time_steps_ms(wl)
    fargs, fkw = step_operands(wl, cfg)
    kernel_ms = time_ms(lambda: fused_step.fused_step_onehot_xfade(*fargs, **fkw))
    plain_ms = time_ms(lambda: fused_step.fused_step_onehot_xfade_reference(*fargs, **fkw))
    bps = SOURCES * BLOCKS / (step_ms * 1e-3)
    rt = bps * cfg.frames_per_buffer / cfg.sample_rate
    log(f"step: {step_ms:.4f} ms per {SOURCES}x{BLOCKS}-block step -> "
        f"{bps:,.0f} blocks/s = {rt:,.0f}x real time  [{card()}]")
    log(f"fused step alone: kernel {kernel_ms:.4f} ms, plain twin {plain_ms:.4f} ms  [{card()}]")
    rows = profile_steps(wl)
    busy = sum(r[1] for r in rows)
    log(f"device time per step {busy:.4f} ms of {step_ms:.4f} ms "
        f"(idle share {1 - busy / step_ms:.3f}); by kernel:")
    for kernel, ms, calls in rows:
        log(f"  {ms:9.4f} ms  x{calls:g}  {kernel[:110]}")
    print(json.dumps({
        "metric": "blocks_per_sec_per_chip",
        "value": round(bps, 1),
        "unit": "128-sample 44.1kHz blocks/s/chip",
        "vs_baseline": round(bps / BASELINE_BLOCKS_PER_S, 2),
    }))
    return 0
