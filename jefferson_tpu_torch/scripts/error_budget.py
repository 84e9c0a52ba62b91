"""Error budget of the sweep gate's worst-case margin, on the card.

The counterpart of ``scripts/error_budget.py``: it renders the worst sweep
scenario (azi3_ele0: ``AzimuthSweep(3, 0, r=0.5, 5-degree steps, 172
blocks x 73 positions)``) through configurations that each move one stage
into a hand kernel, every one against the same float32 NumPy oracle, and
splits the margin against the sweep's 2e-7 among them:

  unfused      - ``Renderer(fused=False)``: the plain torch chain, every
                 stage in eager torch and cuBLAS.
  apply_kernel - the forward DFT and the distance ramp in plain torch, the
                 apply, tail IDFT and crossfade in the apply-only kernel
                 (row 7), by patching ``renderer._apply_maybe_full_fuse``
                 and ``renderer.dedup_distance`` for one render; the patch
                 is undone even when the render raises.
  fused        - production: the dedup+fused dispatch, forward and
                 distance in the kernel too (row 5).

and the unfused chain with one stage swapped at a time, the reading that
found which of its stages read over the CPU's margin on a card:

  unfused/tail_one_product - the tail IDFT as one product per plane over
                 all 513 bins (``ops/fft.irfft_tail_split``), where the
                 unfused chain's tail (``ops/fft.irfft_tail``) sums five
                 128-bin block products in order, the association the
                 kernels keep;
  unfused/forward_cpu - the sliding forward (``ops/fft.rfft_sliding_split``)
                 computed on the CPU and copied to the device.

and the fused configuration with one stage swapped:

  fused/sidepass_blocked - the sparse side-pass's old-side tail
                 (``engine/renderer._sparse_xfade_fix``) summed by 128-bin
                 blocks (``ops/fft.irfft_tail``), as launch B and the
                 unfused chain sum theirs, where production takes one
                 product over 513 bins (``ops/fft.irfft_tail_split``);
                 ``sidepass_blocked`` makes the swap for any render
                 (chip_smoke.py's sweep phase also reads scene_hold with it).

plus the blend micro A/B the configurations do not isolate: the one-hot
blend as one ``torch.matmul`` against ``blend_cat``'s gather, on the
scenario's first 2,048 old rows.  ``lane512`` and ``tail_tree`` are TPU
layouts the port does not have; the result names them as absent, with the
reason.  Each configuration reports its worst sample (block, in-block
sample, channel, crossfade state), the margin beside two of the JAX
package's: ``scripts/error_budget.py --cpu`` on these same inputs (XLA and
the Pallas interpreter on the CPU), and its ladder on a TPU with the real
KEMAR set and the Castanets recording; and on a card the kernels it
launched.  ``unfused`` and ``unfused/tail_one_product`` also report
``render_ms``: a second render of the scenario, timed from one device
synchronise to the next.

    python -m jefferson_tpu_torch.scripts.error_budget [--device cuda]
        [--blocks 172] [--steps 72]

The signal is 0.2-std noise from seed 0 (131,072 samples); the result
names the Castanets recording as absent, with the reason.  Prints one line
per configuration and the JSON; ``main`` returns it as a dict.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..convert import spectra_from_numpy
from ..engine import renderer as R
from ..engine.plan import compact_filter_ids, make_plan
from ..hrtf.kemar import load_database, synthetic_database
from ..kernels import fused_step
from ..kernels.fused_apply import fused_apply_xfade
from ..ops import fft as fft_ops
from ..ops.filters import cmul, distance_factors_split
from ..oracle.reference import render_oracle
from ..testing import precision_check
from ..trajectory.trajectory import AzimuthSweep

SWEEP_EPS = 2e-7
# The JAX package's ladder on the same scenario (its PERF.md, round 5: real
# compact KEMAR set, Castanets, TPU v5e); tail_tree took it back to 0.745.
JAX_MARGIN = {"unfused": 0.745, "apply_kernel": 0.894, "fused": 0.894, "lane512": 0.894,
              "tail_tree": 0.745}
# ``scripts/error_budget.py --cpu`` on this script's inputs (the synthetic
# set, the noise, azi3_ele0 at 172 x 72): its "xla" configuration is the
# unfused chain, the others run its Pallas kernels in interpret mode.
JAX_CPU_MARGIN = {"unfused": 0.7451, "apply_kernel": 0.7451, "fused": 0.7451,
                  "lane512": 0.7451, "tail_tree": 0.5215}
SIGNAL = {"used": "0.2-std noise from seed 0, 131,072 samples",
          "castanets": "absent: the JAX ladder's Castanets recording is not in the repository"}
ABSENT = {
    "lane512": "a TPU lane layout (K = 512 tails and a VPU Nyquist term) the port does not "
               "have: it computes the same function in the plain 513-bin layout "
               "(ROADMAP.md, queue 1)",
    "tail_tree": "a TPU MXU accumulation (the tail cut by 128-bin blocks into a pairwise "
                 "tree) the port does not have as a switch: its fused steps always sum "
                 "the tail by 128-bin blocks (csrc/fused_forward.cuh, the blocked tail)",
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def scenario(blocks: int = 172, steps: int = 72, config=DEFAULT_CONFIG) -> np.ndarray:
    """The worst sweep scenario's per-block positions (azi3_ele0)."""
    traj = AzimuthSweep(start_azi=3.0, ele=0.0, r=0.5, step_deg=5.0,
                        blocks_per_step=blocks, num_steps=steps)
    return traj.sample(traj.total_blocks, config)


def noise(samples: int = 131072) -> np.ndarray:
    """The sweep CLI's default input: 0.2-std noise from seed 0."""
    return (np.random.default_rng(0).standard_normal(samples) * 0.2).astype(np.float32)


def _forward_on_cpu(stream, num_blocks, sub, n, _forward=fft_ops.rfft_sliding_split):
    """The sliding forward computed on the CPU, its planes copied back."""
    return tuple(a.to(stream.device) for a in _forward(stream.cpu(), num_blocks, sub, n))


@contextlib.contextmanager
def patched(module, **attrs):
    """Set ``module``'s attributes for the ``with`` block only, restored
    even when it raises."""
    saved = {name: getattr(module, name) for name in attrs}
    try:
        for name, value in attrs.items():
            setattr(module, name, value)
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def _apply_only(full, u_hi, u_lo, inv_frac, g_old, g_last, xf, config, num_blocks, dsel=None,
                n_dist=None, with_xfade=True):
    """``renderer._apply_maybe_full_fuse`` with the forward DFT and the
    distance ramp in plain torch and the apply-only step (row 7) after
    them: the branch the renderer takes for unaligned histories."""
    if n_dist is not None:
        raise ValueError("the apply-only configuration keeps per-row distance ramps")
    fpb = config.frames_per_buffer
    xr, xi = R._forward_split(full, num_blocks, config)
    xdr, xdi = cmul(xr, xi, *distance_factors_split(u_hi, u_lo, inv_frac, config.num_bins))
    icr, ici = fft_ops.on_device(fft_ops._idft_tail_matrices, config.pad_len, fpb,
                                 device=full.device)
    return fused_apply_xfade(xdr, xdi, g_old, g_last, xf, icr, ici, seg=num_blocks,
                             bins=config.num_bins, fpb=fpb, with_xfade=with_xfade)


def apply_kernel_patch():
    """Route the renderer's fused arms through ``_apply_only`` and turn the
    compact distance off, for the ``with`` block only."""
    return patched(R, _apply_maybe_full_fuse=_apply_only, dedup_distance=lambda *a, **k: None)


# the unfused chain's stage swaps: configuration -> the ops/fft function it replaces
SWAPS = {
    "unfused/tail_one_product": {"irfft_tail": fft_ops.irfft_tail_split},
    "unfused/forward_cpu": {"rfft_sliding_split": _forward_on_cpu},
}


def sidepass_blocked():
    """The sparse side-pass's old-side tail summed by 128-bin blocks for the
    ``with`` block only (its one caller of ``irfft_tail_split`` on a render
    path), restored even when a render raises."""
    return patched(fft_ops, irfft_tail_split=fft_ops.irfft_tail)


def blend_micro_ab(db, plan, device) -> dict:
    """One-hot blend (one ``torch.matmul`` of the one-hot weights by the
    compact table) against ``blend_cat``'s gather, on the scenario's first
    2,048 old rows."""
    nbs = min(2048, plan.num_blocks)
    io = plan.idx_old[:nbs][None]
    il = plan.idx_new[nbs - 1 : nbs]
    uniq_ids, ridx, _, u_pad = compact_filter_ids(io, il[None])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cat = R.cat_table(spectra_from_numpy(db.spectra, device))
    table = cat[put(uniq_ids).long()]
    g_gather = fused_step.blend_cat(cat, put(plan.idx_old[:nbs]), put(plan.w_old[:nbs]))
    onehot = np.zeros((nbs, u_pad), np.float32)
    for k in range(4):
        np.add.at(onehot, (np.arange(nbs), ridx[0, :, k]), plan.w_old[:nbs, k])
    g_onehot = torch.matmul(put(onehot), table)
    diff = float((g_gather - g_onehot).abs().max())
    peak = float(g_gather.abs().max())
    log(f"[blend] one-hot matmul vs gather: max|diff| {diff:.3e} (peak {peak:.3f})")
    return {"max_abs": diff, "table_peak": peak, "u_pad": int(u_pad),
            "note": "one-hot torch.matmul blend vs blend_cat gather, same rows"}


def run(db, signal, positions, want, device) -> dict:
    """Every configuration on ``device`` against the oracle render ``want``
    -> the budget as a dict."""
    config = db.config
    fpb = config.frames_per_buffer
    plan = make_plan(positions, config, (0.0, 0.0))

    def anatomy(rep):
        blk, rem = divmod(rep.max_index, 2 * fpb)
        sample, chan = divmod(rem, 2)
        return {
            "max_abs": rep.max_abs_diff,
            "margin": round(rep.max_abs_diff / SWEEP_EPS, 4),
            "block": int(blk),
            "in_block_sample": int(sample),
            "channel": int(chan),
            "xfade_at_block": bool(plan.xfade[blk]) if blk < len(plan.xfade) else None,
            "rms": rep.rms,
        }

    results = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_config(name, make_renderer, timed=False):
        t0 = time.time()
        before = dict(fused_step.launches)
        r = make_renderer()
        got = r.render(signal, positions, initial_old=(0.0, 0.0))
        if timed:  # a second, warm render: the first paid for the bases' uploads
            sync()
            t1 = time.perf_counter()
            r.render(signal, positions, initial_old=(0.0, 0.0))
            sync()
            render_ms = (time.perf_counter() - t1) * 1e3
        rep = precision_check(got, want, eps=SWEEP_EPS)
        res = results[name] = anatomy(rep)
        d = np.abs(got.astype(np.float64) - want)
        res["n_above_1e7"] = int((d > 1.0e-7).sum())
        res["n_above_1p5e7"] = int((d > 1.5e-7).sum())
        res["jax_margin"] = JAX_MARGIN[name.split("/")[0]]
        res["jax_cpu_margin"] = JAX_CPU_MARGIN[name.split("/")[0]]
        res["dispatch"] = sorted({"/".join(map(str, arm)) for arm in r.dispatch})
        res["launches"] = {k: v - before[k] for k, v in fused_step.launches.items()
                           if v != before[k]}
        if timed:
            res["render_ms"] = render_ms
        log(f"[{name}] {rep}  ({time.time() - t0:.1f} s)  margin {res['margin']} "
            f"(JAX package: {res['jax_cpu_margin']} on the CPU, {res['jax_margin']} on a TPU), >1e-7: {res['n_above_1e7']}, "
            f">1.5e-7: {res['n_above_1p5e7']}, launches {res['launches']}"
            + (f", warm render {render_ms:.1f} ms" if timed else ""))

    run_config("unfused", lambda: R.Renderer(db, device=device, fused=False), timed=True)
    for name, swap in SWAPS.items():
        with patched(fft_ops, **swap):
            run_config(name, lambda: R.Renderer(db, device=device, fused=False),
                       timed="irfft_tail" in swap)
    with apply_kernel_patch():
        run_config("apply_kernel", lambda: R.Renderer(db, device=device))
    run_config("fused", lambda: R.Renderer(db, device=device))
    with sidepass_blocked():
        run_config("fused/sidepass_blocked", lambda: R.Renderer(db, device=device))
    for name, why in ABSENT.items():
        results[name] = {"absent": why, "jax_margin": JAX_MARGIN[name],
                         "jax_cpu_margin": JAX_CPU_MARGIN[name]}
    results["signal"] = SIGNAL
    results["blend_micro_ab"] = blend_micro_ab(db, plan, device)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--blocks", type=int, default=172, help="blocks per sweep position")
    ap.add_argument("--steps", type=int, default=72, help="azimuth steps (positions - 1)")
    ap.add_argument("--hrtf-dir", default=None,
                    help="an HRTF database (a full or compact KEMAR tree, or a SOFA file; "
                         "default: the synthetic set)")
    args = ap.parse_args(argv)
    device = R.resolve_device(args.device)
    db = (synthetic_database(DEFAULT_CONFIG) if args.hrtf_dir is None
          else load_database(args.hrtf_dir, DEFAULT_CONFIG))
    signal = noise()
    positions = scenario(args.blocks, args.steps, db.config)
    log(f"worst scenario azi3_ele0: {len(positions)} blocks on {device}")
    t0 = time.time()
    want = render_oracle(signal, db, [tuple(p) for p in positions], db.config,
                         initial_old=(0.0, 0.0))
    log(f"oracle: {time.time() - t0:.0f} s")
    results = run(db, signal, positions, want, device)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
