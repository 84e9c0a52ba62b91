"""``jefferson_tpu_torch.bench.sweep``, the sweep gate, against the JAX
package's: the scenarios' position sets bit for bit, and each gate at a
small scale on the CPU (the kernels' twins) reporting ok with every render
within 5e-7 (TOL_JAX) of the JAX ``Renderer``/``BatchRenderer`` render of
the same scenario.  Also: the ``bench/`` package keeps every name of the
module it replaced, and its ``__main__`` runs.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jefferson_tpu.bench import sweep as jsweep
from jefferson_tpu.engine.batch import BatchRenderer as JBatchRenderer
from jefferson_tpu.engine.renderer import Renderer as JRenderer
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.bench import sweep as tsweep
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.engine.renderer import Renderer

torch.set_num_threads(1)

TOL_JAX = 5e-7
ROOT = Path(__file__).resolve().parents[1]
BLOCKS, STEPS = 8, 12  # the CLI's --selftest scale: 104 blocks a scenario
MOVER_B = 64
SCENE_B = 64
# sources a scene scenario takes: 4 sources of movers fit one compact table
# (the shared one-hot arm), so the grouped arm the scenario pins needs 16
SCENE_S = {"hold": 4, "movers": 16}


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


@pytest.fixture(scope="module")
def signal():
    return (np.random.default_rng(0).standard_normal(8 * 128 * 16) * 0.2).astype(np.float32)


@pytest.fixture
def renders(monkeypatch):
    """Every (render, oracle) pair a gate checks, in order."""
    got = []
    check = tsweep.precision_check

    def recording(a, b, eps):
        got.append((np.asarray(a), np.asarray(b)))
        return check(a, b, eps=eps)

    monkeypatch.setattr(tsweep, "precision_check", recording)
    return got


@pytest.mark.parametrize("nb", [1, 172, 997, 2048])
def test_mover_positions_equal(nb):
    np.testing.assert_array_equal(tsweep.mover_positions(nb), jsweep.mover_positions(nb))
    np.testing.assert_array_equal(tsweep.mover_positions(nb, 31), jsweep.mover_positions(nb, 31))


@pytest.mark.parametrize("s,nb", [(1, 5), (4, 400), (16, 700)])
def test_scene_position_sets_equal(s, nb):
    np.testing.assert_array_equal(tsweep.scene_hold_positions(s, nb),
                                  jsweep.scene_hold_positions(s, nb))
    np.testing.assert_array_equal(tsweep.scene_hold_positions(s, nb, 50),
                                  jsweep.scene_hold_positions(s, nb, 50))
    np.testing.assert_array_equal(tsweep.scene_mover_positions(s, nb),
                                  jsweep.scene_mover_positions(s, nb))


def test_benchmark_sweep_matches_the_jax_renderer(db, tdb, signal, renders):
    reports = tsweep.run_benchmark_sweep(
        signal, tdb, blocks_per_step=BLOCKS, num_steps=STEPS,
        renderer=Renderer(tdb, device="cpu", chunk_blocks=104))
    assert len(reports) == 4 and all(r.ok for r in reports), [str(r) for r in reports]
    jr = JRenderer(db, db.config, chunk_blocks=104)
    for (azi, ele), (got, _) in zip(tsweep.SCENARIOS, renders):
        pos = tsweep.sweep_scenario(azi, ele, BLOCKS, STEPS)
        np.testing.assert_array_equal(
            pos, jsweep.AzimuthSweep(start_azi=azi, ele=ele, r=0.5, step_deg=5.0,
                                     blocks_per_step=BLOCKS, num_steps=STEPS).sample(
                                         BLOCKS * (STEPS + 1), db.config))
        want = jr.render(signal, pos, initial_old=(0.0, 0.0))
        assert float(np.abs(got - want).max()) <= TOL_JAX, (azi, ele)


def test_mover_gate_matches_the_jax_renderer(db, tdb, signal, renders):
    rep = tsweep.run_mover_gate(signal, tdb, num_blocks=MOVER_B, device="cpu")
    assert rep.ok, str(rep)
    (got, oracle), = renders
    want = JRenderer(db, db.config).render(signal, jsweep.mover_positions(MOVER_B),
                                           initial_old=(0.0, 0.0))
    assert float(np.abs(got - want).max()) <= TOL_JAX
    assert got.shape == oracle.shape == (MOVER_B * 128, 2)


@pytest.mark.parametrize("scenario,arm", [("hold", "dedup_fused"), ("movers", "onehot_grouped")])
def test_scene_gate_matches_the_jax_batch_renderer(db, tdb, signal, renders, scenario, arm,
                                                   monkeypatch):
    seen = []
    dispatches = tsweep._batch_dispatches
    monkeypatch.setattr(tsweep, "_batch_dispatches", lambda br: seen.append(
        dispatches(br)) or seen[-1])
    n = SCENE_S[scenario]
    rep = tsweep.run_scene_gate(signal, tdb, scenario=scenario, num_sources=n,
                                num_blocks=SCENE_B, chunk_blocks=64, device="cpu")
    assert rep.ok, str(rep)
    assert arm in seen[0]
    pos = (jsweep.scene_hold_positions if scenario == "hold"
           else jsweep.scene_mover_positions)(n, SCENE_B)
    sigs = tsweep.scene_signals(signal, n, SCENE_B)
    want = JBatchRenderer(db, db.config, chunk_blocks=64, mix=False).render(sigs, pos)
    assert len(renders) == n
    for s, (got, _) in enumerate(renders):
        assert float(np.abs(got - np.asarray(want[s])).max()) <= TOL_JAX, s


def test_scene_gate_refuses_a_gate_on_the_wrong_arm(tdb, signal):
    """A scene whose chunks take another arm than the one the scenario pins
    fails the gate rather than pass on the wrong kernel."""
    with pytest.raises(AssertionError, match="did not exercise the dedup_fused"):
        tsweep.run_scene_gate(signal, tdb, scenario="hold", num_sources=2, num_blocks=64,
                              chunk_blocks=64, fused=False, device="cpu")
    with pytest.raises(ValueError, match="unknown scene scenario"):
        tsweep.run_scene_gate(signal, tdb, scenario="nope", device="cpu")


def test_gates_take_an_oracle_function(tdb, signal):
    """A caller's oracle (e.g. renders from worker processes) replaces
    render_oracle; a wrong one fails the gate."""
    calls = []

    def oracle(sig, pos):
        calls.append(len(pos))
        return tsweep._oracle(sig, pos, tdb, tdb.config)

    assert tsweep.run_mover_gate(signal, tdb, num_blocks=16, device="cpu", oracle=oracle).ok
    assert calls == [16]
    zeros = lambda sig, pos: np.zeros((len(pos) * 128, 2), np.float32)
    assert not tsweep.run_mover_gate(signal, tdb, num_blocks=16, device="cpu",
                                     oracle=zeros).ok


def test_sweep_cli_on_the_cpu(capsys):
    rc = tsweep.main(["--device", "cpu", "--blocks", "4", "--steps", "3", "--scene-sources",
                      "2"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert '"gate": "benchmark_sweep"' in out and "sweep PASSED" in out
    for name in ("azi0_ele0", "azi3_ele5", "mover", "scene_hold", "scene_movers"):
        assert f"scenario {name}: OK" in out


def test_sweep_cli_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cuda: .*is_available"):
        tsweep.main(["--blocks", "4", "--steps", "1"])


# every public name of jefferson_tpu_torch/bench.py before it became a package
BENCH_NAMES = [
    "BASELINE_BLOCKS_PER_S", "BLOCKS", "PEAK_FP32_FLOPS", "PEAK_HBM_BYTES", "SCENE_FORMS",
    "SOURCES", "STREAM_FORMS", "Workload", "bound_ms", "build_workload", "card",
    "device_profile", "forward_bytes", "forward_flops", "forward_operands", "helix_positions",
    "log", "main", "mover_positions", "moving_scene", "orbit", "parity_rms", "plain_host",
    "profile_steps", "run", "run_step", "scene_hold_positions", "scene_mover_positions",
    "scene_signals", "scene_step", "spatializer_step", "step_flops", "step_operands",
    "stream_step", "sweep_positions", "time_ms", "time_steps_ms", "wide_positions",
    "write_compact_tree",
]


def test_bench_package_keeps_the_module_names():
    assert [n for n in BENCH_NAMES if not hasattr(bench, n)] == []
    assert bench.mover_positions is tsweep.mover_positions


def test_bench_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "jefferson_tpu_torch.bench", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
