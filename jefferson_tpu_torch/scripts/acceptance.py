"""Acceptance pass of the port: the user's journey through its commands,
with synthetic inputs where none are given.  Counterpart of the JAX
package's ``scripts/acceptance.sh``.

1. the port's test files (``tests/test_torch_*.py``; ``--pytest-args``
   replaces them, an empty string skips the step);
2. a render with reverb, a trajectory and ``--viz``;
3. the engine-vs-oracle WAV gate: a ``-t 0`` render and its ``-t 3``
   oracle render through ``cli.check --eps 5e-7``;
4. the graft stages (``python -m jefferson_tpu_torch.graft``): entry() on
   ``--device`` and the mesh paths' dryrun in 4 ranks on the CPU.

Each CLI step runs on ``--device`` (the card by default).  Exits non-zero
on the first failure.

    python -m jefferson_tpu_torch.scripts.acceptance [WORKDIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SWEEP = "sweep:start=0,step=5,blocks=12,steps=24"


def step(title: str) -> None:
    print(f"== {title}", flush=True)


def run(*cmd) -> None:
    """Run one command from the repository's root; raise on failure."""
    subprocess.run([str(c) for c in cmd], cwd=ROOT, check=True)


def synthetic_inputs(work: Path) -> tuple[Path, Path]:
    """A 3-s tremolo tone and a 20,000-tap decaying-noise IR, from seed 0."""
    import numpy as np

    from ..io.wavio import write_wav

    rng = np.random.default_rng(0)
    sr = 44100
    t = np.arange(3 * sr) / sr
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) * (1 + 0.4 * np.sin(2 * np.pi * 2 * t))
    write_wav(work / "in.wav", sig.astype(np.float32), sr, bits=24)
    ir = rng.standard_normal(20000) * np.exp(-np.arange(20000) / 4000) * 0.05
    write_wav(work / "ir.wav", ir.astype(np.float32), sr, bits=24)
    return work / "in.wav", work / "ir.wav"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="acceptance", description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("-i", "--input", default=None, help="input WAV (default: synthetic)")
    p.add_argument("-r", "--reverb", default=None, help="reverb IR WAV (default: synthetic)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--pytest-args", default="tests/test_torch_*.py -q",
                   help="step 1's pytest arguments (globs expanded); empty skips it")
    args = p.parse_args(argv)

    work = Path(args.workdir or tempfile.mkdtemp(prefix="jt_accept_")).resolve()
    work.mkdir(parents=True, exist_ok=True)
    step(f"workdir {work}")
    if args.input is None or args.reverb is None:
        step("no input given; generating synthetic input and IR")
        sin, sir = synthetic_inputs(work)
    src = Path(args.input).resolve() if args.input else sin
    ir = Path(args.reverb).resolve() if args.reverb else sir
    cli = (sys.executable, "-m", "jefferson_tpu_torch.cli.main")
    try:
        step("1. the port's tests")
        pytest_args = [a for pat in shlex.split(args.pytest_args)
                       for a in (sorted(str(x.relative_to(ROOT)) for x in ROOT.glob(pat))
                                 if "*" in pat else [pat])]
        if pytest_args:
            run(sys.executable, "-m", "pytest", *pytest_args)
        else:
            print("skipped (--pytest-args is empty)")

        step(f"2. render with reverb + trajectory + viz (on {args.device})")
        run(*cli, "-i", src, "-r", ir, "--reverb-mode", "reference",
            "--trajectory", "orbit:period=3,ele=10,r=1.5", "--blocks", 512,
            "--chunk-blocks", 512, "-o", work / "orbit.wav", "--viz", "--device", args.device)
        for suffix in (".scene.svg", ".3d.html"):
            if not (work / f"orbit.wav{suffix}").stat().st_size:
                raise SystemExit(f"orbit.wav{suffix} is empty")

        step("3. engine-vs-oracle WAV gate")
        run(*cli, "-i", src, "-t", 0, "--blocks", 300, "--chunk-blocks", 512,
            "--trajectory", SWEEP, "-o", work / "engine.wav", "--quiet", "--device", args.device)
        run(*cli, "-i", src, "-t", 3, "--blocks", 300, "--trajectory", SWEEP,
            "-o", work / "cpu.wav", "--quiet", "--device", args.device)
        run(sys.executable, "-m", "jefferson_tpu_torch.cli.check", work / "engine.wav",
            work / "cpu.wav", "--eps", "5e-7")

        step("4. the graft stages: entry() and the mesh paths' dryrun in 4 ranks")
        run(sys.executable, "-m", "jefferson_tpu_torch.graft", "--device", args.device)
    except subprocess.CalledProcessError as e:
        print(f"== ACCEPTANCE FAILED: {' '.join(map(str, e.cmd))} exited {e.returncode}",
              file=sys.stderr)
        return 1
    step("ACCEPTANCE PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
