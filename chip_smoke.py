#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jefferson_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py

Phases, one line each; any failure exits non-zero without a result line:
  1. env     torch/CUDA versions and the card (nvidia-smi name, power limit);
             fails when torch.cuda.is_available() is false.
  2. build   nvcc builds csrc/fused_step_onehot.cu for sm_90a.
  3. kernel  the CUDA step against its plain-PyTorch twin at the bench shape
             (256 sources x 64 blocks, compact table), with compact and with
             per-row distance: max|diff| <= 5e-7, and the carried
             overlap-save history bit-equal to the stream's tail.
  4. path    the main path with the launch count set to 0 before and read
             after: four bench steps (256 x 64, history carried) through
             batched_chunk_fn_fused, the first against render_oracle, and
             BatchRenderer(device="cuda").render of 16 moving sources x 512
             blocks, every source against render_oracle; max|diff| <= 1e-6
             and RMS < 1e-4 for both, and the kernel launched.
  5. bench   the bench step (blocks/s), and the fused step's kernel and twin
             times in turns (twin, kernel, kernel, twin), beside the card.
Then a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import sys
import time

KERNEL_TOL = 5e-7    # CUDA step vs twin: fp32 DFT sums in another order
ORACLE_TOL = 1e-6    # end to end, tests/test_engine_parity.py
ORACLE_RMS = 1e-4    # bench.py's parity budget
RENDER_S, RENDER_B = 16, 512


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> int:
    print(f"[{phase}] FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def oracle_diff(got, signal, positions, db):
    """(max|diff|, rms) of a rendered (n, 2) source against render_oracle."""
    import numpy as np

    from jefferson_tpu.oracle.reference import render_oracle

    want = render_oracle(signal, db, [tuple(p) for p in positions], db.config)
    d = np.abs(np.asarray(got, np.float64) - want)
    return float(d.max()), float(np.sqrt(np.mean(d**2)))


def main() -> int:
    import torch

    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        return fail("env", "torch.cuda.is_available() is false: no CUDA device")

    import numpy as np

    from jefferson_tpu import DEFAULT_CONFIG, synthetic_database
    from jefferson_tpu_torch import bench
    from jefferson_tpu_torch.engine.batch import BatchRenderer
    from jefferson_tpu_torch.kernels import build, fused_step

    smi = bench.card()
    say("env", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    S, NB = bench.SOURCES, bench.BLOCKS
    device = torch.device("cuda", 0)
    cfg = DEFAULT_CONFIG
    fpb = cfg.frames_per_buffer
    db = synthetic_database(cfg)

    t0 = time.perf_counter()
    lib = build.build("fused_step_onehot")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    say("build", f"{lib.name} in {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}")

    errs = []
    for what, radius_step in (("compact distance", 0.0), ("per-row distance", 0.01)):
        wl = bench.build_workload(db, S, NB, device, radius_step=radius_step)
        if (wl.n_dist is None) != (radius_step > 0):
            return fail("kernel", f"{what}: the workload took the other distance form")
        args, kw = bench.step_operands(wl, cfg)
        got = fused_step.fused_step_onehot_xfade(*args, **kw)
        torch.cuda.synchronize()
        want = fused_step.fused_step_onehot_xfade_reference(*args, **kw)
        err = float((got - want).abs().max())
        _, hists = bench.run_step(wl)
        streams = torch.cat([wl.hists, wl.feds], dim=1)
        hist_ok = torch.equal(hists, streams[:, NB * fpb :])
        say("kernel", f"{what}, {S}x{NB}, U={wl.u_pad}: max|kernel - twin| = {err:.3e} "
                      f"(limit {KERNEL_TOL:.0e}); history bit-equal: {hist_ok}")
        if not (err <= KERNEL_TOL and hist_ok and bool(torch.isfinite(got).all())):
            return fail("kernel", f"{what}: kernel disagrees with its twin")
        errs.append(err)

    # ---- the main path, counted ------------------------------------------
    wl = bench.build_workload(db, S, NB, device)
    signals, positions = bench.moving_scene(RENDER_S, RENDER_B, cfg)
    renderer = BatchRenderer(db, device=device)
    fused_step.launches = 0
    t0 = time.perf_counter()
    first, h = bench.run_step(wl)
    for _ in range(3):
        out, h = bench.run_step(wl, h)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rendered = renderer.render(signals, positions)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = fused_step.launches

    if launches < 4 + RENDER_B // 256:
        return fail("path", f"the main path launched the CUDA step {launches} times")
    finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(out).all())
    if first.shape != (S, NB, fpb, 2) or not finite:
        return fail("path", f"bench step output {tuple(first.shape)} not finite / not (S, nb, fpb, 2)")
    step_max, step_rms = oracle_diff(
        first[0].cpu().numpy().reshape(NB * fpb, 2), wl.feds[0].cpu().numpy(),
        bench.orbit(0, NB, cfg), db,
    )
    say("path", f"4 bench steps {S}x{NB} in {step_s * 1e3:.1f} ms (host clock); step 1 source 0 vs "
                f"render_oracle: max|diff| {step_max:.3e}, rms {step_rms:.3e}")
    if rendered.shape != (RENDER_S, RENDER_B * fpb, 2) or not np.isfinite(rendered).all():
        return fail("path", f"render output {rendered.shape} not finite / not (S, B*fpb, 2)")
    diffs = [oracle_diff(rendered[i], signals[i], positions[i], db) for i in range(RENDER_S)]
    r_max, r_rms = max(d[0] for d in diffs), max(d[1] for d in diffs)
    say("path", f"BatchRenderer {RENDER_S} sources x {RENDER_B} blocks in {render_s:.2f} s "
                f"(host planning included); vs render_oracle (every source): max|diff| "
                f"{r_max:.3e} (limit {ORACLE_TOL:.0e}), rms {r_rms:.3e} (limit {ORACLE_RMS:.0e}); "
                f"{launches} kernel launches on the path")
    if not (max(step_max, r_max) <= ORACLE_TOL and max(step_rms, r_rms) < ORACLE_RMS):
        return fail("path", "the port disagrees with the oracle")

    # ---- timings -----------------------------------------------------------
    step_ms = bench.time_steps_ms(wl)
    args, kw = bench.step_operands(wl, cfg)
    kernel = lambda: fused_step.fused_step_onehot_xfade(*args, **kw)
    twin = lambda: fused_step.fused_step_onehot_xfade_reference(*args, **kw)
    plain_a, kernel_a, kernel_b, plain_b = (bench.time_ms(f) for f in (twin, kernel, kernel, twin))
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    bps = S * NB / (step_ms * 1e-3)
    say("bench", f"{S}x{NB} step {step_ms:.4f} ms = {bps:,.0f} blocks/s; fused step: kernel "
                 f"{kernel_a:.4f}/{kernel_b:.4f} ms, twin {plain_a:.4f}/{plain_b:.4f} ms  "
                 f"[{bench.card()}]")

    print(json.dumps({"kernels": [{
        "name": "fused_step_onehot_xfade",
        "route": "cuda",
        "source": "jefferson_tpu_torch/csrc/fused_step_onehot.cu",
        "replaces": "jefferson_tpu/pallas/fused_step.py:347",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
