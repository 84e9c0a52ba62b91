"""The port's CLI (``python -m jefferson_tpu_torch.cli.main``) and
``cli.check`` against the JAX package's, with ``--device cpu``.

The cases of tests/test_cli.py that apply to the port run on its CLI; the
oracle renders (-t 3/4/5) write WAVs bit-equal to the JAX CLI's on the same
input, and the engine renders (-t 0/1/2, both backends, reverb, scenes)
match the JAX CLI's float WAVs within 5e-7 and the oracle at the engine
gates (1e-6; 5e-6 for TD against the gain-scaled oracle).  ``--viz``,
``--selftest[-full]`` and ``--profile-dir`` render with their artifacts,
gates and trace; ``--devices 4`` renders in 4 gloo ranks on ``--device
cpu`` (a source mesh for ``--scene``, a block mesh for ``-i``) within 1e-6
of the JAX CLI's ``--devices 4`` renders, and ``--device cuda`` without a
card exits instead of rendering on the CPU.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jefferson_tpu.cli.check import main as jcheck
from jefferson_tpu.cli.main import main as jmain
from jefferson_tpu.cli.main import parse_trajectory as jparse
from jefferson_tpu.io.resample import read_wav_mono_at as j_read_at
from jefferson_tpu.io.resample import resample as jresample
from jefferson_tpu_torch import ProcessType as P
from jefferson_tpu_torch.cli import main as tcli
from jefferson_tpu_torch.cli.check import main as check_main
from jefferson_tpu_torch.cli.main import parse_trajectory, render_scene_spec
from jefferson_tpu_torch.config import DEFAULT_CONFIG as CFG
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.io.resample import read_wav_mono_at, resample
from jefferson_tpu_torch.io.wavio import read_wav, write_wav
from jefferson_tpu_torch.oracle.reference import render_oracle
from jefferson_tpu_torch.testing import precision_check

torch.set_num_threads(1)

TOL_JAX = 5e-7
E2E_EPS = 1e-6
TD_EPS = 5e-6


@pytest.fixture
def wav_in(tmp_path, castanets):
    p = tmp_path / "in.wav"
    write_wav(p, castanets[:16000], 44100, bits=24)
    return p


@pytest.fixture(autouse=True)
def synthetic_set(monkeypatch):
    monkeypatch.delenv("JEFFERSON_HRTF_DIR", raising=False)


def _run(args, device="cpu"):
    return tcli.main([str(a) for a in args] + (["--device", device] if device else []))


def _jrun(args):
    return jmain([str(a) for a in args] + ["--device", "cpu"])


def test_chunk_blocks_validation(tmp_path, wav_in):
    out = tmp_path / "out.wav"
    for bad in (0, -4):
        with pytest.raises(SystemExit, match="positive block count"):
            _run(["-i", wav_in, "-o", out, "--chunk-blocks", bad, "--quiet"])


def test_render_roundtrip(tmp_path, wav_in):
    out = tmp_path / "out.wav"
    rc = _run(["-i", wav_in, "-o", out, "-t", 0, "--blocks", 20,
               "--trajectory", "orbit:period=1,r=1", "--chunk-blocks", 16, "--quiet"])
    assert rc == 0
    y, sr = read_wav(out)
    assert sr == 44100 and y.shape == (20 * 128, 2)
    assert np.abs(y).max() > 1e-4


def test_oracle_and_engine_agree_via_cli(tmp_path, wav_in):
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    common = ["-i", wav_in, "--blocks", 12, "--trajectory", "static:azi=40,ele=10,r=1",
              "--chunk-blocks", 12, "--quiet", "--float", "--bits", 32]
    assert _run(["-t", 0, "-o", a] + common) == 0
    assert _run(["-t", 3, "-o", b] + common) == 0
    assert check_main([str(a), str(b), "--eps", "1e-6"]) == 0
    assert check_main([str(a), str(wav_in), "--eps", "1e-6"]) == 1


SPECS = {
    "static": "static:azi=30,ele=-10,r=2",
    "orbit": "orbit:period=0.3,ele=10,r=1.5,start=90",
    "sweep": "sweep:start=10,step=7,blocks=5,steps=3",
    "path": "path:0.3,1.2,-0.3:-1,0.2,0.5:0.05",
}


@pytest.mark.parametrize("ptype", [3, 4, 5])
@pytest.mark.parametrize("spec", ["static", "orbit", "path"])
def test_oracle_wavs_bit_equal_to_the_jax_cli(tmp_path, wav_in, ptype, spec):
    """-t 3/4/5 render the oracle: the port's WAV bytes equal the JAX CLI's
    on the same input, 24-bit and float."""
    for fmt in ([], ["--float"]):
        a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
        common = ["-i", wav_in, "-t", ptype, "--blocks", 24, "--trajectory", SPECS[spec],
                  "--quiet", *fmt]
        assert _run(common + ["-o", a]) == 0
        assert _jrun(common + ["-o", b]) == 0
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("backend", ["matmul", "fft"])
@pytest.mark.parametrize("ptype", [0, 1, 2])
def test_engine_wavs_match_the_jax_cli_and_the_oracle(tmp_path, wav_in, castanets, ptype,
                                                       backend):
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    common = ["-i", wav_in, "-t", ptype, "--blocks", 40, "--backend", backend,
              "--trajectory", SPECS["orbit"], "--chunk-blocks", 16, "--quiet", "--float"]
    assert _run(common + ["-o", a]) == 0
    assert _jrun(common + ["-o", b]) == 0
    got, want = read_wav(a)[0], read_wav(b)[0]
    assert precision_check(got, want, eps=TOL_JAX).ok
    sig = read_wav(wav_in)[0][:, 0]
    pos = parse_trajectory(SPECS["orbit"]).sample(40, CFG)
    td = ptype == 2
    oracle = render_oracle(sig, synthetic_database(), [tuple(p) for p in pos], CFG,
                           P(ptype + 3), td_gain=CFG.source_gain if td else 1.0)
    rep = precision_check(got, oracle, eps=TD_EPS if td else E2E_EPS)
    assert rep.ok, rep


def test_scene_rendering(tmp_path, wav_in, castanets):
    second = tmp_path / "in2.wav"
    write_wav(second, np.roll(castanets, 777)[:12000], 44100, bits=24)
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps({"sources": [
        {"input": str(wav_in), "trajectory": "orbit:period=1,r=1", "gain": 0.8},
        {"input": str(second), "trajectory": "static:azi=270,ele=0,r=2", "gain": 0.5},
    ]}))
    out, jout = tmp_path / "mix.wav", tmp_path / "jmix.wav"
    common = ["--scene", scene, "--blocks", 16, "--chunk-blocks", 16, "--quiet", "--float"]
    assert _run(common + ["-o", out]) == 0
    assert _jrun(common + ["-o", jout]) == 0
    y, _ = read_wav(out)
    assert y.shape == (16 * 128, 2) and np.abs(y).max() > 1e-4
    assert precision_check(y, read_wav(jout)[0], eps=TOL_JAX).ok


def test_trajectory_parsing(tmp_path):
    t = parse_trajectory("static:azi=30,ele=-10,r=2")
    assert (t.azi, t.ele, t.r) == (30, -10, 2)
    t = parse_trajectory("orbit:period=4,start=90")
    assert t.period_s == 4 and t.start_azi == 90
    t = parse_trajectory("sweep:start=10,blocks=5,steps=3")
    assert t.blocks_per_step == 5 and t.num_steps == 3
    t = parse_trajectory("path:0,0,1:1,0,-1:2.5")
    assert t.duration_s == 2.5
    ev = tmp_path / "ev.json"
    ev.write_text(json.dumps([[0.0, 10, 0, 1], [0.01, 40, 5, 1.5], [0.02, -30, 10, 2]]))
    for spec in [*SPECS.values(), f"events:{ev}"]:
        np.testing.assert_array_equal(parse_trajectory(spec).sample(50, CFG),
                                      jparse(spec).sample(50, CFG))
    for bad, match in (("spiral:x=1", "unknown trajectory kind"),
                       ("orbit:frequency=2", "unknown trajectory parameter"),
                       ("static:azi=abc", "needs a number"), ("static:azi", "needs a number"),
                       ("events:/nonexistent/events.json", "not found")):
        with pytest.raises(ValueError, match=match):
            parse_trajectory(bad)


def test_empty_scene_rejected(tmp_path):
    scene = tmp_path / "empty.json"
    scene.write_text(json.dumps({"sources": []}))
    with pytest.raises(SystemExit, match="scene has no sources"):
        _run(["--scene", scene, "-o", tmp_path / "x.wav", "--quiet"])


def test_resampling_input(tmp_path, castanets):
    p = tmp_path / "in22.wav"
    write_wav(p, castanets[:8000], 22050, bits=16)
    out = tmp_path / "o.wav"
    assert _run(["-i", p, "-o", out, "--blocks", 10, "--chunk-blocks", 10, "--quiet"]) == 0
    y, sr = read_wav(out)
    assert sr == 44100 and y.shape[0] == 1280


def test_resample_function(tmp_path):
    t = np.arange(22050) / 22050
    sig = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    up = resample(sig, 22050, 44100)
    np.testing.assert_array_equal(up, jresample(sig, 22050, 44100))
    assert abs(len(up) - 44100) <= 2
    spec = np.abs(np.fft.rfft(up[:32768] * np.hanning(32768)))
    assert abs(np.argmax(spec) * 44100 / 32768 - 440) < 3
    for sr_in, sr_out in ((48000, 44100), (44100, 48000), (44100, 44100)):
        np.testing.assert_array_equal(resample(sig, sr_in, sr_out), jresample(sig, sr_in, sr_out))
    rows = np.stack([sig[:1000], sig[1000:2000]])
    np.testing.assert_array_equal(resample(rows, 48000, 44100), jresample(rows, 48000, 44100))
    p = tmp_path / "s.wav"
    write_wav(p, np.stack([sig, sig[::-1]], -1), 48000, bits=24)
    np.testing.assert_array_equal(read_wav_mono_at(p, 44100), j_read_at(p, 44100))


def test_device_cuda_without_a_card_exits(tmp_path, wav_in):
    """No fallback: the default --device cuda exits without a card, for
    every process type, rather than render on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for ptype in (0, 3):
        with pytest.raises(SystemExit, match="--device cuda: .*is_available"):
            _run(["-i", wav_in, "-o", tmp_path / "o.wav", "-t", ptype, "--blocks", 4,
                  "--quiet"], device=None)
    assert not (tmp_path / "o.wav").exists()


def test_device_cpu_flag(tmp_path, wav_in):
    out = tmp_path / "dev.wav"
    assert _run(["-i", wav_in, "-o", out, "--blocks", 8,
                 "--trajectory", "orbit:period=1,r=1", "--quiet"]) == 0
    y, _ = read_wav(out)
    assert y.shape[0] == 8 * 128 and np.isfinite(y).all()


ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("form", ["scene", "single"])
def test_devices_flag_renders_like_the_jax_cli(tmp_path, wav_in, form):
    """tests/test_batch_parallel.py:308: `--scene --devices 4` (sources on a
    src mesh) and `-i --devices 4` (blocks on a blk mesh) reach the mesh
    from the CLI; here the CLI re-executes itself as 4 gloo ranks on the CPU
    and rank 0 writes a WAV within 1e-6 of the JAX CLI's on 4 devices."""
    if form == "scene":
        scene = tmp_path / "scene.json"
        scene.write_text(json.dumps({"sources": [
            {"input": str(wav_in), "trajectory": f"orbit:period=0.5,start={i * 45}"}
            for i in range(8)]}))
        args = ["--scene", scene]
    else:
        args = ["-i", wav_in, "--trajectory", "orbit:period=0.5"]
    args += ["--blocks", 32, "--chunk-blocks", 16, "--devices", 4, "--quiet", "--float",
             "--bits", 32]
    out = tmp_path / "port.wav"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "jefferson_tpu_torch.cli.main",
                           *map(str, args), "-o", str(out), "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "re-exec as 4 ranks (gloo, cpu)" in proc.stderr
    jout = tmp_path / "jax.wav"
    assert jmain([*map(str, args), "-o", str(jout), "--device", "cpu"]) == 0
    got, _ = read_wav(out)
    want, _ = read_wav(jout)
    assert got.shape == want.shape == (32 * 128, 2)
    assert np.abs(got - want).max() <= E2E_EPS


def test_ranks_past_the_cli_mesh_stay_idle(tmp_path, wav_in):
    """A world larger than the CLI's mesh (torchrun with more ranks than
    --devices, or a scene that shrinks it): the ranks past the mesh render
    nothing and exit 0, and rank 0 writes what one device renders.  Four
    gloo ranks run `-i --devices 2` (a blk mesh of 2) and `--scene
    --devices 4` on 6 sources (shrunk to a src mesh of 3)."""
    from jefferson_tpu_torch.parallel import mesh as pm

    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps({"sources": [
        {"input": str(wav_in), "trajectory": f"orbit:period=0.5,start={i * 45}"}
        for i in range(6)]}))
    common = ["--blocks", "32", "--chunk-blocks", "16", "--quiet", "--float", "--bits", "32",
              "--device", "cpu"]
    forms = {"single": ["-i", str(wav_in), "--trajectory", "orbit:period=0.5", *common,
                        "--devices", "2"],
             "scene": ["--scene", str(scene), *common, "--devices", "4"]}
    code = ("import sys; from jefferson_tpu_torch.cli.main import main; sys.exit(" + " or ".join(
        f"main({[*args, '-o', str(tmp_path / f'{form}_world.wav')]!r})"
        for form, args in forms.items()) + ")")
    env = {k: v for k, v in os.environ.items() if k != "JEFFERSON_HRTF_DIR"}
    env["OMP_NUM_THREADS"] = "1"
    port = pm.free_port()
    failed, outs = pm.spawn([[sys.executable, "-c", code]] * 4,
                            [pm.rank_env(env, r, 4, port) for r in range(4)], timeout=240)
    assert not failed, "\n".join(outs)
    for form, args in forms.items():
        one = tmp_path / f"{form}_one.wav"
        assert _run([*args[:-2], "-o", one], device=None) == 0
        got, _ = read_wav(tmp_path / f"{form}_world.wav")
        want, _ = read_wav(one)
        assert got.shape == want.shape == (32 * 128, 2)
        assert np.abs(got - want).max() <= (1e-7 if form == "single" else E2E_EPS), form


def test_devices_need_the_cards_they_name(tmp_path, wav_in):
    """On cuda the ranks take one card each (NCCL): fewer raise, as
    make_mesh does in the JAX package; a chunk that does not divide over
    the devices exits before any rank starts; one device renders alone."""
    with pytest.raises(SystemExit, match="--devices 2: requested 2 devices, have 0"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--blocks", 4, "--quiet",
              "--devices", "2"], device="cuda")
    with pytest.raises(SystemExit, match="chunk size 16 must divide evenly over --devices 3"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--blocks", 4, "--chunk-blocks", 16,
              "--quiet", "--devices", "3"])
    with pytest.raises(SystemExit, match="--devices 0 must be positive"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--devices", "0"])
    assert not (tmp_path / "o.wav").exists()
    assert _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--blocks", 4, "--quiet",
                 "--devices", "1"]) == 0


def test_scene_mesh_shrink_warning(capsys):
    """tests/test_cli.py:422: --devices that does not divide the sources
    shrinks to the largest divisor, loudly when not quiet; a mesh needs a
    world of as many ranks (the CLI's ensure_world makes one)."""
    assert tcli.scene_devices(6, 4, quiet=False) == 3
    assert "shrunk to 3" in capsys.readouterr().err
    assert tcli.scene_devices(6, 4, quiet=True) == 3
    assert capsys.readouterr().err == ""
    assert tcli.scene_devices(6, 8) == 6 and tcli.scene_devices(9, 8) == 3
    assert tcli.scene_devices(6, 1) == 1 and tcli.scene_devices(5, 3) == 1
    assert tcli.scene_mesh(6, 1) is None and tcli.scene_mesh(5, 3, device="cpu") is None
    with pytest.raises(ValueError, match="requested 3 devices, have 1"):
        tcli.scene_mesh(6, 4, device="cpu")


@pytest.fixture
def scaled_sweep(monkeypatch):
    """The sweep gates as --selftest-full calls them, recorded, then run at
    8 blocks x 2 steps and a 64-block mover on the twins (the full workload
    is chip_smoke.py's, on the card)."""
    from jefferson_tpu_torch.bench import sweep

    seen = {}
    run_sweep, run_mover = sweep.run_benchmark_sweep, sweep.run_mover_gate

    def scaled(signal, db, config, **kw):
        seen["sweep"] = dict(kw)
        return run_sweep(signal, db, config, **{**kw, "blocks_per_step": 8, "num_steps": 2})

    def scaled_mover(signal, db, config, **kw):
        seen["mover"] = dict(kw)
        return run_mover(signal, db, config, **{**kw, "num_blocks": 64})

    monkeypatch.setattr(sweep, "run_benchmark_sweep", scaled)
    monkeypatch.setattr(sweep, "run_mover_gate", scaled_mover)
    return seen


@pytest.mark.parametrize("flag", ["--viz", "--selftest", "--selftest-full", "--profile-dir"])
def test_surface_flags_work_on_the_cpu(tmp_path, wav_in, flag, scaled_sweep, capsys):
    """The flags of ROADMAP item 8 render on the CPU: --viz writes its four
    artifacts, --selftest and --selftest-full pass their gates (the full one
    asks for the reference's 172 x 72 workload and the 12,556-block mover on
    one renderer), --profile-dir writes a trace with the CLI's stages."""
    out = tmp_path / "o.wav"
    args = [flag, tmp_path / "prof"] if flag == "--profile-dir" else [flag]
    assert _run(["-i", wav_in, "-o", out, "--blocks", 8, "--chunk-blocks", 8,
                 "--trajectory", "orbit:period=1", *args]) == 0
    assert read_wav(out)[0].shape == (8 * 128, 2)
    err = capsys.readouterr().err
    if flag == "--viz":
        for suffix in (".scene.svg", ".wave.svg", ".html", ".3d.html"):
            assert (tmp_path / f"o.wav{suffix}").stat().st_size > 0, suffix
        assert "viz:" in err
    elif flag == "--profile-dir":
        trace, = (tmp_path / "prof").glob("trace.*.json")
        spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"}
        assert {"cli.read_wav", "cli.load_hrtf", "cli.render", "renderer.plan",
                "renderer.chunks", "cli.write"} <= spans, spans
    else:
        kind = "full benchmarkTesting" if flag == "--selftest-full" else "scaled smoke"
        assert f"selftest passed (engine-vs-oracle sweep gate, {kind})" in err
        if flag == "--selftest-full":
            assert scaled_sweep["sweep"]["blocks_per_step"] == 172
            assert scaled_sweep["sweep"]["num_steps"] == 72
            assert "num_blocks" not in scaled_sweep["mover"]  # the 12,556-block default
            assert scaled_sweep["sweep"]["renderer"] is scaled_sweep["mover"]["renderer"]


def test_selftest_failure_exits_naming_the_scenario(tmp_path, wav_in, monkeypatch):
    from jefferson_tpu_torch.bench import sweep
    from jefferson_tpu_torch.testing import PrecisionReport

    bad = PrecisionReport(ok=False, max_abs_diff=1.0, max_index=0, first_bad_index=0,
                          rms=1.0, eps=2e-7)
    monkeypatch.setattr(sweep, "run_benchmark_sweep", lambda *a, **k: [bad])
    with pytest.raises(SystemExit, match=r"selftest FAILED at scenario \(0.0,0.0\)"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--blocks", 8, "--selftest", "--quiet"])
    assert not (tmp_path / "o.wav").exists()


def test_float_flag_with_default_bits(tmp_path, wav_in):
    out = tmp_path / "out.wav"
    assert _run(["-i", wav_in, "-o", out, "--blocks", 8, "--chunk-blocks", 8,
                 "--float", "--quiet"]) == 0
    fmt_tag, _, _, _, _, bits = struct.unpack_from("<HHIIHH", out.read_bytes()[:36], 20)
    assert fmt_tag == 3 and bits == 32
    y, sr = read_wav(out)
    assert sr == 44100 and np.isfinite(y).all()


def test_scene_source_resampled(tmp_path, castanets):
    db = synthetic_database()
    raw = castanets[:8000]
    lo, hi = tmp_path / "lo.wav", tmp_path / "hi.wav"
    write_wav(lo, raw, 22050, bits=32, float_format=True)
    write_wav(hi, resample(raw, 22050, CFG.sample_rate), CFG.sample_rate, bits=32,
              float_format=True)

    def scene(p):
        return {"sources": [{"input": str(p), "trajectory": "static:azi=30,ele=0,r=1"}]}

    out_lo, _ = render_scene_spec(scene(lo), db, CFG, num_blocks=8, chunk_blocks=8, device="cpu")
    out_hi, _ = render_scene_spec(scene(hi), db, CFG, num_blocks=8, chunk_blocks=8, device="cpu")
    np.testing.assert_array_equal(out_lo, out_hi)


def test_scene_rejects_bad_blocks_and_empty_source(tmp_path):
    db = synthetic_database()
    empty = tmp_path / "empty.wav"
    write_wav(empty, np.zeros(0, np.float32), 44100)
    sc = {"sources": [{"input": str(empty), "trajectory": "static:azi=0,ele=0,r=1"}]}
    with pytest.raises(ValueError, match="is empty"):
        render_scene_spec(sc, db, CFG, num_blocks=4, device="cpu")
    ok = tmp_path / "ok.wav"
    write_wav(ok, np.ones(512, np.float32) * 0.1, 44100)
    sc = {"sources": [{"input": str(ok), "trajectory": "static:azi=0,ele=0,r=1"}]}
    with pytest.raises(ValueError, match="blocks .0. must be positive"):
        render_scene_spec(sc, db, CFG, num_blocks=0, device="cpu")
    with pytest.raises(ValueError, match="duration .0.*must be positive"):
        render_scene_spec(sc, db, CFG, duration=0.0, device="cpu")
    with pytest.raises(ValueError, match="chunk_blocks .0. must be positive"):
        render_scene_spec(sc, db, CFG, chunk_blocks=0, device="cpu")
    # one source shrinks any --devices to one device: no mesh, no world
    out, nb = render_scene_spec(sc, db, CFG, num_blocks=4, devices=2, device="cpu")
    assert out.shape == (4 * 128, 2) and nb == 4


def test_empty_input_rejected(tmp_path):
    empty = tmp_path / "empty.wav"
    write_wav(empty, np.zeros(0, np.float32), 44100)
    with pytest.raises(SystemExit, match="is empty"):
        _run(["-i", empty, "-o", tmp_path / "out.wav", "--quiet"])


def test_renderer_constructors_reject_bad_chunk_blocks():
    from jefferson_tpu_torch import BatchRenderer, Renderer

    db = synthetic_database(n_taps=16)
    with pytest.raises(ValueError, match="must be positive"):
        Renderer(db, CFG, device="cpu", chunk_blocks=0)
    with pytest.raises(ValueError, match="must be positive"):
        BatchRenderer(db, CFG, device="cpu", chunk_blocks=-1)
    assert BatchRenderer(db, CFG, device="cpu").config is CFG


def test_scene_rejects_unsupported_flags(tmp_path, castanets):
    src = tmp_path / "s.wav"
    write_wav(src, castanets[:3000], CFG.sample_rate)
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps({"sources": [{"input": str(src), "trajectory": "static:azi=0"}]}))
    base = ["--scene", scene, "-o", tmp_path / "o.wav", "--quiet", "--blocks", 4]
    for extra in (["-r", src], ["--no-fused"], ["--viz"], ["-t", "3"], ["-i", src],
                  ["--initial-old", "none"], ["--backend", "fft"], ["--selftest"]):
        with pytest.raises(SystemExit, match="scene does not support"):
            _run(base + extra)
    assert _run(base) == 0


def test_single_source_blocks_validation(tmp_path, castanets):
    src = tmp_path / "in.wav"
    write_wav(src, castanets[:3000], CFG.sample_rate)
    base = ["-i", src, "-o", tmp_path / "o.wav", "--quiet"]
    with pytest.raises(SystemExit, match="--blocks 0 must be positive"):
        _run(base + ["--blocks", "0"])
    with pytest.raises(SystemExit, match="--duration -1.0 must be positive"):
        _run(base + ["--duration", "-1"])
    with pytest.raises(SystemExit, match="initial-old"):
        _run(base + ["--blocks", "2", "--initial-old", "0,0,0"])
    with pytest.raises(SystemExit, match="needs a number"):
        _run(base + ["--blocks", "2", "--trajectory", "static:azi=abc"])


def test_check_fails_on_length_mismatch(tmp_path, castanets, capsys):
    """cli.check is a pinned copy: the same verdicts and the same report as
    the JAX gate on each pair of files."""
    full = np.stack([castanets[:2000]] * 2, axis=-1)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(a, full, CFG.sample_rate)
    for other, want_rc in ((full[:1500], 1), (full[:0], 1), (full, 0), (full * 1.001, 1)):
        write_wav(b, other, CFG.sample_rate)
        capsys.readouterr()
        assert check_main([str(a), str(b)]) == want_rc
        port_out = capsys.readouterr().out
        assert jcheck([str(a), str(b)]) == want_rc
        assert port_out == capsys.readouterr().out
    write_wav(b, full, 22050)
    assert check_main([str(a), str(b)]) == 1
    assert "sample rates differ" in capsys.readouterr().out


def test_version_flag(capsys):
    from jefferson_tpu_torch import __version__

    with pytest.raises(SystemExit) as e:
        tcli.main(["--version"])
    assert e.value.code == 0
    assert f"jefferson_tpu_torch {__version__}" in capsys.readouterr().out


def test_cli_error_paths(tmp_path, wav_in):
    with pytest.raises(SystemExit, match="missing -i/--input"):
        _run(["-o", tmp_path / "o.wav"])
    with pytest.raises(SystemExit, match="not found"):
        _run(["--scene", tmp_path / "nope.json", "-o", tmp_path / "o.wav"])
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(SystemExit, match="bad JSON"):
        _run(["--scene", bad, "-o", tmp_path / "o.wav"])
    with pytest.raises(SystemExit, match="requires -r/--reverb"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--reverb-mode", "linear"])
    with pytest.raises(SystemExit, match="does not exist"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--hrtf-dir", tmp_path / "no_such_hrtf"])
    with pytest.raises(SystemExit, match="must be positive"):
        _run(["-i", wav_in, "-o", tmp_path / "o.wav", "--blocks", "0"])


def test_events_trajectory_bad_json(tmp_path):
    bad = tmp_path / "ev.json"
    bad.write_text("[[0, 10,")
    with pytest.raises(ValueError, match="bad JSON"):
        parse_trajectory(f"events:{bad}")
    with pytest.raises(ValueError, match="path spec"):
        parse_trajectory("path:0,0,1:1,0,-1")
    with pytest.raises(ValueError, match="numeric"):
        parse_trajectory("path:a,b,c:1,0,-1:2.0")


def test_initial_old_parsing(tmp_path, wav_in):
    out = tmp_path / "io.wav"
    assert _run(["-i", wav_in, "-o", out, "--blocks", "2", "--initial-old", "none",
                 "--quiet"]) == 0
    assert _run(["-i", wav_in, "-o", out, "--blocks", "2", "--initial-old", "30,-10",
                 "--quiet"]) == 0
    with pytest.raises(SystemExit, match="initial-old"):
        _run(["-i", wav_in, "-o", out, "--blocks", "2", "--initial-old", "a,b"])


def test_non_quiet_render_and_scene_summaries(tmp_path, wav_in, castanets, capsys):
    out = tmp_path / "out.wav"
    assert _run(["-i", wav_in, "-o", out, "--blocks", 6,
                 "--trajectory", "static:azi=10,ele=0,r=1", "--chunk-blocks", 6]) == 0
    err = capsys.readouterr().err
    assert "x real time ->" in err and "TPU_FD_COMPLEX: 6 blocks" in err
    assert "synthetic test set" in err
    foreign = tmp_path / "f22k.wav"
    write_wav(foreign, castanets[:8000], 22050, bits=16)
    spath = tmp_path / "scene.json"
    spath.write_text(json.dumps({"sources": [
        {"input": str(foreign), "trajectory": "static:azi=0,ele=0,r=1"}]}))
    sout = tmp_path / "scene_out.wav"
    duration = 3.5 * 128 / 44100.0
    assert _run(["--scene", spath, "-o", sout, "--duration", f"{duration:.8f}",
                 "--chunk-blocks", 4]) == 0
    err2 = capsys.readouterr().err
    assert "resampled" in err2 and "22050 -> 44100" in err2
    assert "scene: 1 sources, 4 blocks" in err2
    y, sr = read_wav(sout)
    assert sr == 44100 and y.shape == (4 * 128, 2)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_reverb_reference_mode_and_ir_resample(tmp_path, wav_in, capsys, backend):
    ir = np.zeros(400, np.float32)
    ir[0], ir[200] = 1.0, 0.5
    ir_path = tmp_path / "ir22k.wav"
    write_wav(ir_path, ir, 22050, bits=16)
    out, jout = tmp_path / "wet.wav", tmp_path / "jwet.wav"
    common = ["-i", wav_in, "--blocks", 6, "-r", ir_path, "--reverb-mode", "reference",
              "--trajectory", "static:azi=0,ele=0,r=1", "--chunk-blocks", 6, "--float",
              "--reverb-backend"]
    assert _run(common + [backend, "-o", out]) == 0
    err = capsys.readouterr().err
    assert "resampled reverb IR 22050 -> 44100" in err and "reverb (reference):" in err
    y, _ = read_wav(out)
    assert np.abs(y).max() > 1e-4
    assert _jrun(common + [{"host": "host", "device": "tpu"}[backend], "-o", jout]) == 0
    assert precision_check(y, read_wav(jout)[0], eps=TOL_JAX).ok


def test_reverb_linear_mode_matches_the_jax_cli(tmp_path, wav_in):
    rng = np.random.default_rng(3)
    ir = (rng.standard_normal(1500) * np.exp(-np.arange(1500) / 200) * 0.2).astype(np.float32)
    ir_path = tmp_path / "ir.wav"
    write_wav(ir_path, ir, 44100, bits=32, float_format=True)
    out, jout = tmp_path / "lin.wav", tmp_path / "jlin.wav"
    common = ["-i", wav_in, "-r", ir_path, "--reverb-mode", "linear", "--quiet", "--float",
              "--trajectory", "orbit:period=0.5", "--chunk-blocks", 64]
    assert _run(common + ["--reverb-backend", "device", "-o", out]) == 0
    assert _jrun(common + ["--reverb-backend", "tpu", "-o", jout]) == 0
    y, j = read_wav(out)[0], read_wav(jout)[0]
    assert y.shape == j.shape == (int(np.ceil((16000 + 1499) / 128)) * 128, 2)
    assert precision_check(y, j, eps=TOL_JAX).ok


def test_scene_renderer_cache_quantizes_short_durations(tmp_path, castanets):
    db = synthetic_database()
    src = tmp_path / "s.wav"
    write_wav(src, castanets[:8000], CFG.sample_rate)
    scene = {"sources": [{"input": str(src), "trajectory": "static:azi=20,ele=0,r=1"}]}
    cache = {}
    for nb in (5, 7, 8):
        out, got_nb = render_scene_spec(scene, db, CFG, num_blocks=nb, chunk_blocks=64,
                                        renderer_cache=cache, device="cpu")
        assert got_nb == nb and out.shape == (nb * CFG.frames_per_buffer, 2)
    assert list(cache) == [(8, "cpu")]
    render_scene_spec(scene, db, CFG, num_blocks=48, chunk_blocks=64, renderer_cache=cache,
                      device="cpu")
    assert set(cache) == {(8, "cpu"), (64, "cpu")}
    for cb in range(9, 18):  # the LRU keeps at most 8 renderers
        render_scene_spec(scene, db, CFG, num_blocks=cb, chunk_blocks=cb,
                          renderer_cache=cache, device="cpu")
    assert len(cache) == tcli._SCENE_RENDERER_CACHE_MAX


def test_no_resample_warning(tmp_path, castanets, capsys):
    p22 = tmp_path / "in22.wav"
    write_wav(p22, castanets[:8000], 22050, bits=16)
    assert _run(["-i", p22, "-o", tmp_path / "raw.wav", "--blocks", 6, "--chunk-blocks", 6,
                 "--no-resample"]) == 0
    assert "rendering raw (pitch-shifted" in capsys.readouterr().err


def test_hrtf_dir_compact_tree_and_sofa(tmp_path, wav_in):
    """--hrtf-dir loads a compact tree and a SOFA file; the renders equal
    the JAX CLI's on the same database (oracle bit for bit, engine 5e-7)."""
    h5py = pytest.importorskip("h5py")
    from jefferson_tpu_torch.bench import write_compact_tree

    db = synthetic_database()
    root = write_compact_tree(db, tmp_path / "compact")
    sofa = tmp_path / "set.sofa"
    from jefferson_tpu_torch.hrtf.kemar import NUM_HRTF, grid_position

    eles, azis = zip(*(grid_position(i) for i in range(NUM_HRTF)))
    with h5py.File(sofa, "w") as f:
        f.create_dataset("Data.IR", data=db.hrirs[:, :, : CFG.hrtf_len].astype(np.float64))
        f.create_dataset("Data.SamplingRate", data=np.array([44100.0]))
        pos = np.stack([np.mod(-np.asarray(azis, np.float64), 360.0), eles,
                        np.full(NUM_HRTF, 1.4)], axis=1)
        f.create_dataset("SourcePosition", data=pos).attrs["Type"] = np.bytes_("spherical")
    for hrtf in (root, sofa):
        for ptype in (0, 3):
            a, b = tmp_path / "a.wav", tmp_path / "b.wav"
            common = ["-i", wav_in, "-t", ptype, "--blocks", 20, "--hrtf-dir", hrtf,
                      "--trajectory", "orbit:period=0.3", "--quiet", "--float"]
            assert _run(common + ["-o", a]) == 0
            assert _jrun(common + ["-o", b]) == 0
            if ptype == 3:
                assert a.read_bytes() == b.read_bytes()
            else:
                assert precision_check(read_wav(a)[0], read_wav(b)[0], eps=TOL_JAX).ok


def test_events_trajectory_renders(tmp_path, wav_in):
    ev = tmp_path / "ev.json"
    ev.write_text(json.dumps([[0.0, 0, 0, 0.5], [0.02, 40, 4, 0.5], [0.05, 300, 30, 1.0]]))
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    common = ["-i", wav_in, "--blocks", 30, "--trajectory", f"events:{ev}", "--quiet",
              "--float", "--chunk-blocks", 8]
    assert _run(common + ["-o", a, "-t", 0]) == 0
    assert _run(common + ["-o", b, "-t", 3]) == 0
    assert check_main([str(a), str(b), "--eps", "1e-6"]) == 0
