"""The first vector-math call of a process (scripts/first_step.py): after
the package's import, the cosines of the distance planes and the graft
dryrun's stage (a) come out the same on every call, and the script's
summary counts each mode of each phase."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from jefferson_tpu_torch.scripts import first_step

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("mode", first_step.MODES)
def test_each_mode_agrees_with_itself_after_the_import(mode):
    assert first_step.child(mode) == {"mode": mode, "diff": 0.0}


def test_the_summary_counts_every_mode_of_each_phase():
    p = subprocess.run([sys.executable, "-m", "jefferson_tpu_torch.scripts.first_step",
                        "--quiet", "1", "--seconds", "0", "--workers", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["graft_rcs"] == []
    for mode in first_step.MODES:
        assert summary[f"quiet {mode}"]["processes"] == 1
        assert summary[f"loaded {mode}"]["processes"] == 0
    assert summary["quiet port"]["differing"] == summary["quiet stage_a"]["differing"] == 0
