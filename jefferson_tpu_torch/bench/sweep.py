"""The reference's benchmarkTesting as a library: the engine-vs-oracle sweep
gate, on the card.  Counterpart of ``jefferson_tpu/bench/sweep.py``.

Reference semantics (reference: Jefferson/src/precision_test.cu:2093-2201):
four scenarios (azi, ele) in {(0,0),(3,0),(0,5),(3,5)}; each renders
``blocks_per_step`` blocks at the start position, then ``num_steps`` rounds
of azimuth += 5 (wrapping at 360), comparing the interpolating engine
against the CPU oracle at eps=2e-7, with crossfade state starting from
old=(0,0) like the reference's reset.  Three more scenarios pin the kernels
the four do not reach: the per-block mover (``Renderer``'s one-hot rows),
and two 16-source scenes through ``BatchRenderer`` (``scene_hold``: the
dedup+fused arm, row 6; ``scene_movers``: the grouped one-hot arm, row 2).

Every gate takes ``device`` (the card unless the caller asks for the CPU,
where the kernels' twins run) and ``oracle``: a function of (signal,
positions) returning the oracle render, ``render_oracle`` from old=(0,0)
when None; a caller may hand the oracle renders to worker processes.

    python -m jefferson_tpu_torch.bench.sweep [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig, ProcessType
from ..engine.renderer import Renderer
from ..hrtf.kemar import HRTFDatabase
from ..oracle.reference import render_oracle
from ..testing import PrecisionReport, precision_check
from ..trajectory.trajectory import AzimuthSweep

SCENARIOS = [(0.0, 0.0), (3.0, 0.0), (0.0, 5.0), (3.0, 5.0)]

# headroom warning threshold: the reference gate is eps=2e-7; once the worst
# scenario uses more than this fraction of it, a contraction-order change is
# one step from failing the gate (the JAX package's value)
MARGIN_WARN = 0.95


def mover_positions(num_blocks: int, ele_period: int = 997) -> np.ndarray:
    """Per-block mover for the gate's 5th scenario: azimuth orbits 1.3 deg
    per block (a crossfade EVERY block) while elevation sweeps the full
    -40..90 grid, touching all four interpolation cases and more unique
    filters per 2048-block chunk than one compact table takes.

    The four reference scenarios hold each position for 172 blocks, so
    they reach only the dedup(+fused) dispatch; this scenario pins the
    one-hot / grouped mover kernels under the same full-scale oracle gate."""
    i = np.arange(num_blocks)
    azi = (i * 1.3) % 360.0
    ele = 25.0 + 65.0 * np.sin(i * (2.0 * np.pi / ele_period))
    return np.stack([azi, ele, np.full(num_blocks, 0.5)], axis=1)


def scene_hold_positions(
    num_sources: int, num_blocks: int, blocks_per_step: int = 172
) -> np.ndarray:
    """(S, B, 3) multi-source scene whose sources each HOLD positions for
    ``blocks_per_step`` blocks (the reference's benchmarkTesting cadence,
    precision_test.cu:2093-2148) at staggered start azimuths, elevations and
    radii: the scene shape that takes the batch dedup+fused dispatch."""
    step = np.arange(num_blocks) // blocks_per_step
    eles = [0.0, 10.0, -20.0, 40.0]
    pos = np.empty((num_sources, num_blocks, 3), np.float64)
    for s in range(num_sources):
        pos[s, :, 0] = (s * (360.0 / num_sources) + 5.0 * step) % 360.0
        pos[s, :, 1] = eles[s % len(eles)]
        pos[s, :, 2] = 0.5 + 0.1 * (s % 3)
    return pos


def scene_mover_positions(num_sources: int, num_blocks: int) -> np.ndarray:
    """(S, B, 3) wide-mover scene: every source orbits EVERY BLOCK in its
    own elevation band, so the scene's unique filters exceed one compact
    table while each source's fit: the shape that takes the batched grouped
    one-hot dispatch (per-group table slices in one launch)."""
    i = np.arange(num_blocks)
    pos = np.empty((num_sources, num_blocks, 3), np.float64)
    for s in range(num_sources):
        speed = 2.1 + 0.13 * (s % 7)  # degrees per block: a crossfade every block
        pos[s, :, 0] = (s * (360.0 / num_sources) + speed * i) % 360.0
        # distinct elevation bands spread the union across the grid's rings
        pos[s, :, 1] = -30.0 + (s % 8) * 15.0
        pos[s, :, 2] = 1.0
    return pos


def scene_signals(signal: np.ndarray, num_sources: int, num_blocks: int, fpb: int = 128):
    """(S, n) per-source streams of the scene gate: rotated copies of one
    signal (cheap, and each keeps a realistic spectrum)."""
    n = max(len(signal), num_blocks * fpb)
    base = np.resize(np.asarray(signal, np.float32), n)
    return np.stack([np.roll(base, -(s * 7919 * fpb) % n) for s in range(num_sources)])


def _oracle(signal, positions, db, config):
    return render_oracle(signal, db, [tuple(p) for p in positions], config,
                         initial_old=(0.0, 0.0))


def run_mover_gate(
    signal: np.ndarray,
    db: HRTFDatabase,
    config: EngineConfig = DEFAULT_CONFIG,
    num_blocks: int = 12556,
    eps: float = 2e-7,
    renderer: Renderer | None = None,
    *,
    device="cuda",
    oracle=None,
) -> PrecisionReport:
    """Engine-vs-oracle gate on the per-block mover trajectory."""
    renderer = renderer or Renderer(db, config, device=device)
    pos = mover_positions(num_blocks)
    got = renderer.render(signal, pos, ProcessType.TPU_FD_COMPLEX, initial_old=(0.0, 0.0))
    want = (oracle or (lambda s, p: _oracle(s, p, db, config)))(signal, pos)
    return precision_check(got, want, eps=eps)


def _batch_dispatches(br) -> set[str]:
    """The arms a BatchRenderer's last render took on its chunks:
    'dedup_fused', 'onehot_grouped', 'onehot_shared', 'gather_fused',
    'dedup', 'plain' (``BatchRenderer.dispatch``)."""
    return {arm for arm, _xf, _bucket in br.dispatch}


def run_scene_gate(
    signal: np.ndarray,
    db: HRTFDatabase,
    config: EngineConfig = DEFAULT_CONFIG,
    scenario: str = "hold",
    num_sources: int = 16,
    num_blocks: int = 12556,
    eps: float = 2e-7,
    chunk_blocks: int = 256,
    require_dispatch: bool = True,
    fused: bool = True,
    *,
    device="cuda",
    oracle=None,
) -> PrecisionReport:
    """Full-scale engine-vs-oracle gate for the BATCHED/scene kernels: a
    multi-source scene through ``BatchRenderer``, EVERY source's stream
    against its own oracle render at the same eps (a summed-mix comparison
    would dilute per-stream error into the sum's amplitude).  Returns the
    worst source's report.

    scenario 'hold'   -> sources hold positions  -> batch dedup+fused (row 6)
    scenario 'movers' -> every-block wide movers -> batched grouped one-hot (row 2)
    ``require_dispatch`` asserts the intended arm took a chunk, so the gate
    cannot pass on another kernel than the one it pins.  chunk_blocks 256
    keeps the JAX package's tile geometry, so the dispatch is its dispatch.
    """
    from ..engine.batch import BatchRenderer

    # whole chunks only, as the JAX gate renders them
    if num_blocks > chunk_blocks:
        num_blocks = (num_blocks // chunk_blocks) * chunk_blocks
    if scenario == "hold":
        positions = scene_hold_positions(num_sources, num_blocks)
        want_dispatch = "dedup_fused"
    elif scenario == "movers":
        positions = scene_mover_positions(num_sources, num_blocks)
        want_dispatch = "onehot_grouped"
    else:
        raise ValueError(f"unknown scene scenario {scenario!r}")
    signals = scene_signals(signal, num_sources, num_blocks, config.frames_per_buffer)
    br = BatchRenderer(db, config, device=device, chunk_blocks=chunk_blocks, mix=False,
                       fused=fused)
    outs = br.render(signals, positions)  # (S, B*fpb, 2)
    if require_dispatch:
        got_d = _batch_dispatches(br)
        if want_dispatch not in got_d:
            raise AssertionError(
                f"scene '{scenario}' gate did not exercise the {want_dispatch} "
                f"dispatch (took: {sorted(got_d)}): the gate would pin the wrong kernel"
            )
    oracle = oracle or (lambda s, p: _oracle(s, p, db, config))
    worst = None
    for s in range(num_sources):
        rep = precision_check(outs[s], oracle(signals[s], positions[s]), eps=eps)
        if worst is None or rep.max_abs_diff > worst.max_abs_diff:
            worst = rep
        if not rep.ok:
            break  # a failure is already the gate's answer
    return worst


def sweep_scenario(azi: float, ele: float, blocks_per_step: int = 172, num_steps: int = 72,
                   r: float = 0.5, config: EngineConfig = DEFAULT_CONFIG) -> np.ndarray:
    """One reference scenario's (B, 3) positions: ``blocks_per_step`` blocks
    a position, ``num_steps`` 5-degree steps from (azi, ele)."""
    traj = AzimuthSweep(start_azi=azi, ele=ele, r=r, step_deg=5.0,
                        blocks_per_step=blocks_per_step, num_steps=num_steps)
    return traj.sample(traj.total_blocks, config)


def run_benchmark_sweep(
    signal: np.ndarray,
    db: HRTFDatabase,
    config: EngineConfig = DEFAULT_CONFIG,
    blocks_per_step: int = 172,
    num_steps: int = 72,
    eps: float = 2e-7,
    r: float = 0.5,
    renderer: Renderer | None = None,
    scenarios=None,
    *,
    device="cuda",
    oracle=None,
) -> list[PrecisionReport]:
    """Run the 4-scenario sweep; returns one PrecisionReport per scenario."""
    renderer = renderer or Renderer(db, config, device=device)
    oracle = oracle or (lambda s, p: _oracle(s, p, db, config))
    reports = []
    for azi, ele in scenarios or SCENARIOS:
        pos = sweep_scenario(azi, ele, blocks_per_step, num_steps, r, config)
        got = renderer.render(signal, pos, ProcessType.TPU_FD_COMPLEX, initial_old=(0.0, 0.0))
        reports.append(precision_check(got, oracle(signal, pos), eps=eps))
    return reports


def main(argv=None) -> int:
    """CLI: full-scale sweep gate (the reference's always-on startup check).

    Emits one JSON line with the per-scenario max|diff| and its margin
    (max|diff| / eps) so headroom is tracked as a regression metric; the
    gate WARNS above MARGIN_WARN.
    """
    import argparse
    import json
    import sys
    import time

    p = argparse.ArgumentParser(prog="jefferson-torch-sweep")
    p.add_argument("-i", "--input", default=None, help="input WAV (default: noise)")
    p.add_argument("--blocks", type=int, default=172)
    p.add_argument("--steps", type=int, default=72)
    p.add_argument("--eps", type=float, default=2e-7)
    p.add_argument("--no-mover", action="store_true",
                   help="skip the per-block mover scenario (the one-hot kernels' gate; "
                        "the 4 reference scenarios only reach the dedup dispatch)")
    p.add_argument("--no-scene", action="store_true",
                   help="skip the two multi-source scene scenarios (the batched "
                        "dedup+fused and grouped one-hot gates: the daemon's and "
                        "--scene's kernels)")
    p.add_argument("--scene-sources", type=int, default=16,
                   help="sources per scene scenario (default 16)")
    p.add_argument("--write-dir", default=None,
                   help="also write each scenario's engine render as a WAV (the "
                        "reference's waveFileTesting, precision_test.cu:2203-2250)")
    p.add_argument("--hrtf-dir", default=None,
                   help="HRTF database (the main CLI's flag; default: "
                        "$JEFFERSON_HRTF_DIR, else the synthetic test set)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the card (the default; raises without one); cpu = "
                        "the kernels' plain twins")
    args = p.parse_args(argv)

    from ..engine.renderer import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}")
    config = DEFAULT_CONFIG
    if args.input:
        from ..io.wavio import read_wav_mono

        signal, _ = read_wav_mono(args.input)
    else:
        signal = (np.random.default_rng(0).standard_normal(131072) * 0.2).astype(np.float32)
    from ..cli.main import load_hrtf

    db = load_hrtf(args.hrtf_dir, config, quiet=False)
    t0 = time.time()
    # one renderer across the sweep, the mover and --write-dir
    renderer = Renderer(db, config, device=device)
    reports = run_benchmark_sweep(
        signal, db, config, blocks_per_step=args.blocks, num_steps=args.steps,
        eps=args.eps, renderer=renderer,
    )
    names = [f"azi{int(a)}_ele{int(e)}" for a, e in SCENARIOS]
    if not args.no_mover:
        reports.append(run_mover_gate(
            signal, db, config, num_blocks=args.blocks * (args.steps + 1), eps=args.eps,
            renderer=renderer,
        ))
        names.append("mover")
    if not args.no_scene:
        nb_scene = args.blocks * (args.steps + 1)
        for scenario in ("hold", "movers"):
            reports.append(run_scene_gate(
                signal, db, config, scenario=scenario, num_sources=args.scene_sources,
                num_blocks=nb_scene, eps=args.eps, device=device,
                # the arm is pinned where the kernels run, as the JAX CLI pins
                # it on the TPU; a scaled-down scene on the twins may take
                # another arm and still gates its render
                require_dispatch=device.type == "cuda",
            ))
            names.append(f"scene_{scenario}")
    ok = True
    for name, rep in zip(names, reports):
        print(f"scenario {name}: {rep}")
        ok &= rep.ok
    margins = {
        n: {"max_abs": rep.max_abs_diff, "margin": round(rep.max_abs_diff / args.eps, 4)}
        for n, rep in zip(names, reports)
    }
    worst = max(margins.values(), key=lambda m: m["margin"])["margin"]
    print(json.dumps({
        "gate": "benchmark_sweep", "eps": args.eps, "ok": ok,
        "worst_margin": worst, "scenarios": margins,
    }))
    if worst > MARGIN_WARN and ok:
        print(
            f"WARNING: worst margin {worst:.2f} of the eps={args.eps:g} budget "
            f"exceeds the {MARGIN_WARN} safety factor: the next contraction-order "
            f"change may fail the gate",
            file=sys.stderr,
        )
    if args.write_dir:
        import pathlib

        from ..io.wavio import write_wav

        outdir = pathlib.Path(args.write_dir)
        outdir.mkdir(parents=True, exist_ok=True)
        for azi, ele in SCENARIOS:
            pos = sweep_scenario(azi, ele, args.blocks, args.steps, config=config)
            out = renderer.render(signal, pos, initial_old=(0.0, 0.0))
            path = outdir / f"sweep_azi{int(azi)}_ele{int(ele)}.wav"
            write_wav(path, out, config.sample_rate)
            print(f"wrote {path}")
    print(f"sweep {'PASSED' if ok else 'FAILED'} in {time.time()-t0:.1f}s")
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
