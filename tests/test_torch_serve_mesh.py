"""The port's render daemon on a mesh of ranks (``serve --devices 2``) on
the CPU: two gloo ranks spawned from this file (``--rank SOCKET``, which
imports no jax), one socket on rank 0.

Held against: the meshless daemon in this process, bit for bit
(``np.array_equal`` on the float WAVs) where both compute the same sums
(``-t 1``'s plain chunk).  For ``-t 0`` the blk mesh turns the fused arms
off, as in the JAX package, so the meshed render is held bit for bit to the
unsharded unfused ``Renderer`` and to the meshless daemon's fused render
within 5e-7 (the JAX package's fused-vs-unfused gate).  A scene's mix is
each rank's sources (bit for bit the unsharded render's) summed, then the
ranks' partial mixes summed (``mix_all_reduce``): held bit for bit to that
sum of the unsharded sources, and to the meshless daemon's one-pass mix
within the rounding of the order (1e-7).  Every reply within 1e-6 of the
JAX render of the same request (tests/test_engine_parity.py:23).  Also: the JAX daemon's chunk message
before any rank starts, ``shutdown`` ending every rank with 0, and a rank
that cannot read a request's inputs answered by rank 0's error reply, not
a hang.  Each spawned world runs under a timeout of its own.
"""

import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jefferson_tpu_torch import serve as tserve
from jefferson_tpu_torch.cli.main import scene_inputs
from jefferson_tpu_torch.engine.batch import BatchRenderer, mix_sources
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.io.wavio import read_wav, write_wav
from jefferson_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

RANKS = 2
CHUNK = 64
TOL_FUSED = 5e-7
TOL_JAX = 1e-6
# four sources of 0.2-std noise summed in another order: a few float32 ulps
MIX_ORDER_TOL = 1e-7
WORLD_TIMEOUT_S = 240.0


def _start_world(sock: Path, fault: bool = False):
    """The meshed daemon: RANKS gloo ranks of this file's ``--rank`` mode."""
    port = pm.free_port()
    cmd = [sys.executable, str(Path(__file__).resolve()), "--rank", str(sock)] + (
        ["--fault"] if fault else [])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(RANKS):
        log = tempfile.TemporaryFile()
        procs.append(subprocess.Popen(cmd, env=pm.rank_env(env, r, RANKS, port), stdout=log,
                                      stderr=subprocess.STDOUT))
        procs[-1].log = log
    return procs


def _wait_up(sock: Path, procs) -> None:
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while time.monotonic() < deadline:
        try:
            if tserve.request(sock, {"cmd": "ping"}, timeout=10)["pong"]:
                return
        except OSError:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    _stop(procs)
    raise AssertionError("the meshed daemon did not come up:\n" + _logs(procs))


def _logs(procs) -> str:
    out = []
    for p in procs:
        p.log.seek(0)
        out.append(p.log.read().decode(errors="replace"))
    return "\n".join(out)


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _shutdown(sock: Path, procs) -> list:
    """shutdown, then every rank's exit code (each within the timeout)."""
    assert tserve.request(sock, {"cmd": "shutdown"}, timeout=60)["shutdown"]
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=60))
    finally:
        _stop(procs)
    return codes


@pytest.fixture(scope="module")
def meshless(tmp_path_factory):
    sock = tmp_path_factory.mktemp("meshless") / "m.sock"
    service = tserve.RenderService(chunk_blocks=CHUNK, device="cpu")
    t = threading.Thread(target=tserve.serve, args=(sock, service), daemon=True)
    t.start()
    for _ in range(400):
        try:
            if tserve.request(sock, {"cmd": "ping"})["pong"]:
                break
        except OSError:
            time.sleep(0.05)
    yield sock
    tserve.request(sock, {"cmd": "shutdown"})
    t.join(timeout=10)


def _signal(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2).astype(np.float32)


def test_meshed_daemon_serves_renders_and_scenes_like_the_meshless_one(meshless, tmp_path):
    from jefferson_tpu import DEFAULT_CONFIG as JAX_CONFIG
    from jefferson_tpu import synthetic_database as jax_synthetic_database
    from jefferson_tpu.cli.main import render_scene_spec as jrender_scene_spec
    from jefferson_tpu.config import ProcessType as JType
    from jefferson_tpu.engine.renderer import Renderer as JRenderer
    from jefferson_tpu.trajectory.trajectory import CircularOrbit

    wav = tmp_path / "in.wav"
    sig = _signal(200 * 128, 1)
    write_wav(wav, sig, 44100, bits=32, float_format=True)
    srcs = []
    for i in range(4):
        srcs.append(tmp_path / f"s{i}.wav")
        write_wav(srcs[-1], _signal(40 * 128, 10 + i), 44100, bits=32, float_format=True)
    scene = {"sources": [
        {"input": str(srcs[0]), "trajectory": "static:azi=60,ele=0,r=1.0", "gain": 0.8},
        {"input": str(srcs[1]), "trajectory": "orbit:period=0.5,ele=5,r=1.2"},
        {"input": str(srcs[2]), "trajectory": "static:azi=300,ele=10,r=0.7"},
        {"input": str(srcs[3]), "trajectory": "orbit:period=0.8,ele=-5,r=1.0"},
    ]}
    reqs = {
        "render": {"cmd": "render", "input": str(wav), "trajectory": "orbit:period=1,ele=5",
                   "blocks": 200, "float": True, "bits": 32},
        "render_t1": {"cmd": "render", "input": str(wav), "trajectory": "orbit:period=1,ele=5",
                      "blocks": 200, "type": 1, "float": True, "bits": 32},
        "scene": {"cmd": "scene", "scene": scene, "blocks": 40, "float": True, "bits": 32},
    }
    sock = tmp_path / "mesh.sock"
    procs = _start_world(sock)
    try:
        _wait_up(sock, procs)
        got, replies = {}, {}
        for name, req in reqs.items():
            out = tmp_path / f"{name}.mesh.wav"
            replies[name] = tserve.request(sock, {**req, "output": str(out)}, timeout=120)
            assert replies[name]["ok"], (name, replies[name])
            got[name] = read_wav(out)[0]
        stats = tserve.request(sock, {"cmd": "stats"}, timeout=30)
        codes = _shutdown(sock, procs)
    finally:
        _stop(procs)
    assert codes == [0] * RANKS, _logs(procs)
    # every rank's record of each step, and the collectives they met
    for name, reply in replies.items():
        steps = [s["step"] for s in reply["ranks"]]
        assert steps == ["read its inputs", "render"], name
        render = reply["ranks"][1]["ranks"]
        assert [r["rank"] for r in render] == [0, 1] and all(r["error"] is None for r in render)
        assert all(sum(r["collectives"].values()) >= 1 for r in render), name
    assert stats["world"] == RANKS and stats["collectives"]["gather_rows"] >= 1
    assert stats["collectives"]["mix_all_reduce"] >= 1

    want = {}
    for name, req in reqs.items():
        out = tmp_path / f"{name}.meshless.wav"
        assert tserve.request(meshless, {**req, "output": str(out)}, timeout=120)["ok"]
        want[name] = read_wav(out)[0]
    # the same arms: bit for bit
    assert np.array_equal(got["render_t1"], want["render_t1"])
    # the scene: each rank's sources bit for bit the meshless render's, its
    # partial mix summed over the ranks (mix_all_reduce); the meshless
    # daemon sums the four sources in one pass, so the mixes differ by the
    # rounding of that order alone
    feds, spos, nb = scene_inputs(scene, synthetic_database().config, num_blocks=40)
    each = torch.from_numpy(BatchRenderer(synthetic_database(), device="cpu").render(feds, spos))
    parts = [mix_sources(each[lo:lo + 2]) for lo in (0, 2)]
    assert np.array_equal(got["scene"], (parts[0] + parts[1]).numpy())
    assert 0 < np.abs(got["scene"] - want["scene"]).max() <= MIX_ORDER_TOL
    # -t 0: the mesh's unfused arms, bit for bit the unsharded unfused render
    pos = CircularOrbit(period_s=1.0, ele=5).sample(200, JAX_CONFIG)
    unfused = Renderer(synthetic_database(), chunk_blocks=CHUNK, fused=False,
                       device="cpu").render(sig, pos)
    assert np.array_equal(got["render"], unfused)
    assert np.abs(got["render"] - want["render"]).max() <= TOL_FUSED
    # the JAX renders of the same requests
    jdb = jax_synthetic_database(JAX_CONFIG)
    jr = JRenderer(jdb, JAX_CONFIG, chunk_blocks=CHUNK)
    assert np.abs(got["render"] - jr.render(sig, pos)).max() <= TOL_JAX
    assert np.abs(got["render_t1"] - jr.render(sig, pos, JType(1))).max() <= TOL_JAX
    jmix, nb = jrender_scene_spec(scene, jdb, JAX_CONFIG, num_blocks=40)
    assert nb == 40 and np.abs(got["scene"] - np.asarray(jmix)).max() <= TOL_JAX


def test_a_rank_that_cannot_read_its_inputs_makes_rank_0s_error_reply(tmp_path):
    """Rank 1 of this world fails to read every render's input
    (``--fault``): rank 0 replies with rank 1's error, the daemon serves the
    next command (a scene), and shutdown still ends both ranks with 0."""
    wav = tmp_path / "in.wav"
    write_wav(wav, _signal(16 * 128, 2), 44100, bits=32, float_format=True)
    sock = tmp_path / "fault.sock"
    procs = _start_world(sock, fault=True)
    try:
        _wait_up(sock, procs)
        t0 = time.monotonic()
        bad = tserve.request(sock, {"cmd": "render", "input": str(wav), "blocks": 16,
                                    "output": str(tmp_path / "bad.wav")}, timeout=120)
        assert time.monotonic() - t0 < 60
        assert not bad["ok"] and bad["error"].startswith("rank 1 could not read its inputs")
        assert "the fault this test gives rank 1" in bad["error"]
        assert [s["step"] for s in bad["ranks"]] == ["read its inputs"]
        assert not (tmp_path / "bad.wav").exists()
        scene = {"sources": [{"input": str(wav), "trajectory": "static:azi=30,ele=0,r=1.0"},
                             {"input": str(wav), "trajectory": "static:azi=90,ele=0,r=1.0"}]}
        ok = tserve.request(sock, {"cmd": "scene", "scene": scene, "blocks": 16,
                                   "output": str(tmp_path / "ok.wav")}, timeout=120)
        assert ok["ok"], ok
        assert tserve.request(sock, {"cmd": "stats"}, timeout=30)["errors"] == 1
        codes = _shutdown(sock, procs)
    finally:
        _stop(procs)
    assert codes == [0] * RANKS, _logs(procs)


def test_a_chunk_that_does_not_divide_over_the_devices_raises_before_any_rank(monkeypatch):
    """The JAX daemon's message (jefferson_tpu/serve.py:78-82), from the
    command line before ``ensure_world`` spawns a rank, and from the
    service."""
    monkeypatch.setattr(pm, "ensure_world",
                        lambda *a, **k: pytest.fail("spawned ranks for a refused chunk"))
    match = r"chunk_blocks \(63\) must divide evenly over devices \(2\)"
    with pytest.raises(SystemExit, match=match):
        tserve.main(["--devices", "2", "--chunk-blocks", "63", "--device", "cpu",
                     "--socket", "unused.sock"])
    with pytest.raises(ValueError, match=match):
        tserve.RenderService(chunk_blocks=63, devices=2, device="cpu")


def _rank_main(sock: str, fault: bool) -> int:
    """One rank of the meshed daemon; with ``fault``, rank 1 cannot read a
    render's input."""
    if fault and os.environ.get("RANK") == "1":
        def refuse(self, req):
            raise OSError("the fault this test gives rank 1")

        tserve.RenderService._render_inputs = refuse
    return tserve.main(["--socket", sock, "--devices", str(RANKS), "--device", "cpu",
                        "--chunk-blocks", str(CHUNK)])


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(_rank_main(args[args.index("--rank") + 1], "--fault" in args))
