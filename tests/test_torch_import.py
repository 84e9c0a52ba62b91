"""The port (every module, the daemon, the live CLI, the sweep, the viz
copies and the scripts among them) imports without jax, triton or anything
of the JAX package,
turns TF32 off, and its chip smoke test imports nothing of the JAX package
and refuses to run without a CUDA device.

Each check runs in a fresh interpreter: tests/conftest.py imports jax into
this one.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "jefferson_tpu_torch",
    "jefferson_tpu_torch.bench",
    "jefferson_tpu_torch.bench.__main__",
    "jefferson_tpu_torch.bench.sweep",
    "jefferson_tpu_torch.cli",
    "jefferson_tpu_torch.cli.check",
    "jefferson_tpu_torch.cli.main",
    "jefferson_tpu_torch.config",
    "jefferson_tpu_torch.convert",
    "jefferson_tpu_torch.diff",
    "jefferson_tpu_torch.diff.personalize",
    "jefferson_tpu_torch.diff.render",
    "jefferson_tpu_torch.engine",
    "jefferson_tpu_torch.engine.batch",
    "jefferson_tpu_torch.engine.plan",
    "jefferson_tpu_torch.engine.renderer",
    "jefferson_tpu_torch.engine.stream",
    "jefferson_tpu_torch.graft",
    "jefferson_tpu_torch.hrtf",
    "jefferson_tpu_torch.hrtf.kemar",
    "jefferson_tpu_torch.hrtf.sofa",
    "jefferson_tpu_torch.io",
    "jefferson_tpu_torch.io.resample",
    "jefferson_tpu_torch.io.wavio",
    "jefferson_tpu_torch.kernels",
    "jefferson_tpu_torch.kernels.assoc_probe",
    "jefferson_tpu_torch.kernels.build",
    "jefferson_tpu_torch.kernels.dma_blend",
    "jefferson_tpu_torch.kernels.fused_apply",
    "jefferson_tpu_torch.kernels.fused_spatializer",
    "jefferson_tpu_torch.kernels.fused_step",
    "jefferson_tpu_torch.native",
    "jefferson_tpu_torch.ops",
    "jefferson_tpu_torch.ops.fft",
    "jefferson_tpu_torch.ops.filters",
    "jefferson_tpu_torch.oracle",
    "jefferson_tpu_torch.oracle.reference",
    "jefferson_tpu_torch.parallel",
    "jefferson_tpu_torch.parallel.mesh",
    "jefferson_tpu_torch.parallel.multihost",
    "jefferson_tpu_torch.parallel.record",
    "jefferson_tpu_torch.reverb",
    "jefferson_tpu_torch.reverb.convolution",
    "jefferson_tpu_torch.rt",
    "jefferson_tpu_torch.rt.__main__",
    "jefferson_tpu_torch.rt.control",
    "jefferson_tpu_torch.rt.playout",
    "jefferson_tpu_torch.scripts",
    "jefferson_tpu_torch.scripts.acceptance",
    "jefferson_tpu_torch.scripts.apply_assoc_probe",
    "jefferson_tpu_torch.scripts.bench_blend_variants",
    "jefferson_tpu_torch.scripts.error_budget",
    "jefferson_tpu_torch.scripts.first_step",
    "jefferson_tpu_torch.scripts.live_sessions",
    "jefferson_tpu_torch.scripts.output_hashes",
    "jefferson_tpu_torch.scripts.soak_daemon",
    "jefferson_tpu_torch.scripts.split_layouts",
    "jefferson_tpu_torch.scripts.tail_times",
    "jefferson_tpu_torch.serve",
    "jefferson_tpu_torch.testing",
    "jefferson_tpu_torch.trajectory",
    "jefferson_tpu_torch.trajectory.interpolation",
    "jefferson_tpu_torch.trajectory.spatial",
    "jefferson_tpu_torch.trajectory.trajectory",
    "jefferson_tpu_torch.utils",
    "jefferson_tpu_torch.utils.profiling",
    "jefferson_tpu_torch.viz",
    "jefferson_tpu_torch.viz.html",
    "jefferson_tpu_torch.viz.live",
    "jefferson_tpu_torch.viz.scene",
    "jefferson_tpu_torch.viz.scene3d",
]


def _python(code: str, cwd=ROOT, timeout=120):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_port_module_lists_in_the_test():
    """Every module and package of the port but its examples (scripts,
    checked by tests/test_torch_examples.py)."""
    found = set()
    for p in (ROOT / "jefferson_tpu_torch").rglob("*.py"):
        parts = p.relative_to(ROOT).with_suffix("").parts
        if "examples" not in parts:
            found.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    assert found == set(PORT_MODULES)


def test_port_imports_without_jax_or_triton():
    code = (
        "import importlib, json, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "import torch\n"
        "print(json.dumps({'jax': sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')),\n"
        "  'triton': 'triton' in sys.modules,\n"
        "  'jax_package': sorted(k for k in sys.modules\n"
        "                        if k == 'jefferson_tpu' or k.startswith('jefferson_tpu.')),\n"
        "  'tf32': [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],\n"
        "  'precision': torch.get_float32_matmul_precision()}))\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "triton": False, "jax_package": [],
                   "tf32": [False, False], "precision": "highest"}


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py imports only the port, torch, numpy and the standard
    library, at any depth of the file."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert "jefferson_tpu_torch" in top
    assert top <= {"jefferson_tpu_torch", "torch", "numpy"} | set(sys.stdlib_module_names), top


def _smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_cuda_device(tmp_path, alone):
    """No CPU fallback: without a card the smoke test exits non-zero and
    prints no result line, from the checkout and alone in a directory."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _smoke(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "is_available() is false" in proc.stderr


def test_bench_refuses_a_cpu_device():
    proc = _python("import sys; from jefferson_tpu_torch import bench; "
                   "sys.exit(bench.main(['--device', 'cpu']))")
    assert proc.returncode == 2
    assert "measures a CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_the_lazy_names_are_the_jax_packages():
    """The port's top-level lazy names are those of jefferson_tpu/__init__.py
    (read from its source: importing it imports jax), and the two of the
    differentiable path resolve, in a fresh interpreter, to the diff
    modules' objects without importing jax or the JAX package."""
    tree = ast.parse((ROOT / "jefferson_tpu" / "__init__.py").read_text())
    jax_lazy = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", None) == "_LAZY")
    code = (
        "import json, sys\n"
        "import jefferson_tpu_torch as jt\n"
        "from jefferson_tpu_torch.diff import personalize, render\n"
        "print(json.dumps({'lazy': sorted(jt._LAZY), 'all': sorted(set(jt._LAZY) - set(jt.__all__)),\n"
        "  'same': [jt.DifferentiableRenderer is render.DifferentiableRenderer,\n"
        "           jt.fit_database is personalize.fit_database],\n"
        "  'jax': sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jefferson_tpu'))}))\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"lazy": sorted(jax_lazy), "all": [], "same": [True, True], "jax": []}
