"""The port's examples (``jefferson_tpu_torch/examples/``) run as a user
runs them: each in its own subprocess from a scratch cwd (they write their
artifacts there), here with ``--device cpu`` (the kernels' twins); each
imports nothing of the JAX package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO / "jefferson_tpu_torch" / "examples").glob("*.py"))
# example -> the artifacts it writes into its cwd
WRITES = {
    "01_offline_render.py": ["orbit.wav", "orbit.scene.svg", "orbit.wave.svg", "orbit.html",
                             "orbit.3d.html"],
    "02_streaming.py": ["stream.wav"],
    "03_localization.py": [],
    "04_multichip.py": [],
    "05_realtime_playout.py": ["live_mix.wav"],
    "06_personalization.py": [],
    "07_live_control.py": ["live_control.wav"],
    "08_daemon_live_viz.py": [],
    "09_multihost.py": [],
    "10_sofa.py": ["listener.sofa", "sofa_orbit.wav"],
    "11_deployment_tuning.py": [],
}


def test_the_nine_examples_are_here():
    assert [p.name for p in EXAMPLES] == sorted(WRITES)


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.name)
def test_example_runs_on_the_cpu(script, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JEFFERSON_HRTF_DIR"}
    proc = subprocess.run([sys.executable, str(script), "--device", "cpu"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"{script.name} failed (rc={proc.returncode})\n--- stdout ---\n"
        f"{proc.stdout[-3000:]}\n--- stderr ---\n{proc.stderr[-3000:]}")
    for name in WRITES[script.name]:
        assert (tmp_path / name).stat().st_size > 0, name
    tree = ast.parse(script.read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    top = {m.split(".")[0] for m in mods}
    assert "jefferson_tpu_torch" in top and not top & {"jax", "jefferson_tpu"}, top
