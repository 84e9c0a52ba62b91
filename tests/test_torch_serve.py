"""The port's render daemon (``jefferson_tpu_torch.serve``) on the CPU
(``device="cpu"``, the kernels' twins), held to the JAX package: a render
against the JAX ``Renderer``, a scene against the JAX CLI's scene render, a
live session against the JAX ``StreamingSpatializer`` over the same blocks,
each within 5e-7 (TOL_JAX); and the protocol's commands and error replies.

Cases ported from tests/test_residual_coverage.py keep clear of its four
faults: a changed ``max_streams`` is restored, no branch is told apart by
wall-clock timing, ``_streams`` is assigned only under ``_slock`` (these
tests never assign it), and a writer is closed in ``finally``.
"""

import json
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

from jefferson_tpu.cli.main import render_scene_spec as jrender_scene_spec
from jefferson_tpu.engine.renderer import Renderer as JRenderer
from jefferson_tpu.engine.stream import StreamingSpatializer as JStreamingSpatializer
from jefferson_tpu.trajectory.trajectory import CircularOrbit
from jefferson_tpu_torch import serve as tserve
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.io.wavio import read_wav, read_wav_mono, write_wav
from jefferson_tpu_torch.rt.control import INITIAL_XYZ
from jefferson_tpu_torch.serve import RenderService, request, serve

torch.set_num_threads(1)

TOL_JAX = 5e-7


def _wait_socket(sock):
    for _ in range(400):
        try:
            if request(sock, {"cmd": "ping"})["pong"]:
                return
        except OSError:
            time.sleep(0.05)
    raise AssertionError("the daemon did not come up")


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tserve")
    sock = tmp / "jt.sock"
    service = RenderService(hrtf_dir=None, chunk_blocks=64, device="cpu")
    t = threading.Thread(target=serve, args=(sock, service), daemon=True)
    t.start()
    _wait_socket(sock)
    yield sock, service
    request(sock, {"cmd": "shutdown"})
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture
def wav(tmp_path, castanets, config):
    src = tmp_path / "in.wav"
    write_wav(src, castanets[:9000, None].repeat(2, 1), config.sample_rate, bits=32,
              float_format=True)
    return src


def _wait_ended(service, sid, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if not service._streams[sid]["thread"].is_alive():
            return
        time.sleep(0.02)
    raise AssertionError(f"session {sid} did not end")


def test_render_matches_the_jax_renderer(daemon, db, config, wav, tmp_path):
    sock, service = daemon
    out = tmp_path / "out.wav"
    resp = request(sock, {"cmd": "render", "id": 7, "input": str(wav), "output": str(out),
                          "trajectory": "orbit:period=1,ele=5,r=1.0", "blocks": 64,
                          "float": True, "bits": 32})
    assert resp["ok"] and resp["id"] == 7 and resp["blocks"] == 64, resp
    pos = CircularOrbit(period_s=1.0, ele=5, r=1.0).sample(64, config)
    want = JRenderer(db, config, chunk_blocks=64).render(
        read_wav(wav)[0].mean(axis=1).astype(np.float32), pos)
    got, sr = read_wav(out)
    assert sr == config.sample_rate and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL_JAX


def test_scene_matches_the_jax_cli_scene(daemon, db, config, castanets, tmp_path):
    sock, _ = daemon
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(a, castanets[:6000], config.sample_rate, bits=32, float_format=True)
    write_wav(b, np.roll(castanets, 500)[:6000], config.sample_rate, bits=32,
              float_format=True)
    scene = {"sources": [
        {"input": str(a), "trajectory": "static:azi=60,ele=0,r=1.0", "gain": 0.8},
        {"input": str(b), "trajectory": "orbit:period=0.5,ele=5,r=1.2"},
    ]}
    out = tmp_path / "mix.wav"
    resp = request(sock, {"cmd": "scene", "scene": scene, "output": str(out), "blocks": 32,
                          "float": True, "bits": 32})
    assert resp["ok"] and resp["sources"] == 2 and resp["blocks"] == 32, resp
    want, nb = jrender_scene_spec(scene, db, config, num_blocks=32)
    got = read_wav(out)[0]
    assert nb == 32 and got.shape == np.asarray(want).shape
    assert float(np.abs(got - np.asarray(want)).max()) <= TOL_JAX
    # a file path works too, and a bad chunk size errors with the daemon alive
    spec = tmp_path / "scene.json"
    spec.write_text(json.dumps(scene))
    assert request(sock, {"cmd": "scene", "scene": str(spec), "output": str(out),
                          "blocks": 32})["ok"]
    bad = request(sock, {"cmd": "scene", "scene": scene, "output": str(out), "blocks": 32,
                         "chunk_blocks": 0})
    assert not bad["ok"] and "must be positive" in bad["error"]


def test_stream_matches_the_jax_streaming_spatializer(daemon, db, config, castanets,
                                                       tmp_path):
    """An unpaced session held at the control's start position: its WAV
    equals, within 5e-7, the JAX StreamingSpatializer fed the same wrapping
    playhead at the same position."""
    sock, service = daemon
    sig = castanets[:3000]  # shorter than the session: the playhead wraps
    src = tmp_path / "live_in.wav"
    write_wav(src, sig, config.sample_rate, bits=32, float_format=True)
    out = tmp_path / "live.wav"
    resp = request(sock, {"cmd": "stream_start", "input": str(src), "output": str(out),
                          "seconds": 0.1, "paced": False})
    assert resp["ok"] and resp["paced"] is False, resp
    n = resp["blocks"]
    assert n == int(np.ceil(0.1 / config.block_duration))
    _wait_ended(service, resp["session"])
    stats = request(sock, {"cmd": "stream_stop", "session": resp["session"]})
    assert stats["ok"] and stats["blocks"] == n, stats
    assert {"median_ms", "p90_ms", "p99_ms", "avg_ms", "max_ms", "misses"} <= set(stats)
    assert stats["crossfades"] == 1  # from the (0, 0) start onto the position

    spat = JStreamingSpatializer(db, config)
    spat.buf = read_wav_mono(src)[0]
    want = []
    for _ in range(n):
        spat.set_position_cartesian(INITIAL_XYZ)
        want.append(spat.process_next())
    got, sr = read_wav(out)
    assert got.shape == (n * 128, 2)
    assert float(np.abs(got - np.concatenate(want)).max()) <= TOL_JAX


def test_live_session_moves_status_list_and_stop(daemon, config, wav, tmp_path):
    """Move by key, Cartesian and spherical forms while a paced session
    plays; status and list report it; stop returns its deadline stats."""
    sock, service = daemon
    out = tmp_path / "live.wav"
    resp = request(sock, {"cmd": "stream_start", "input": str(wav), "output": str(out),
                          "seconds": 20.0, "paced": True})
    assert resp["ok"], resp
    sid = resp["session"]
    try:
        mv = request(sock, {"cmd": "move", "azi": 90, "ele": 10, "r": 1.0})
        assert mv["ok"] and mv["azi"] == 90 and mv["ele"] == 10, mv
        assert request(sock, {"cmd": "move", "key": "w"})["ok"]
        mv = request(sock, {"cmd": "move", "session": sid, "x": 0.5, "y": 0.0, "z": -0.5})
        # atan2(-x, -z) convention (SoundSource.cu:29): (0.5, -0.5) -> 315 deg
        assert mv["ok"] and mv["azi"] == 315, mv
        bad = request(sock, {"cmd": "move", "azimuth": 10})
        assert not bad["ok"] and "move needs one of" in bad["error"]
        st = request(sock, {"cmd": "stream_status"})
        assert st["ok"] and st["alive"] and st["azi"] == 315 and st["total_blocks"] == resp[
            "blocks"]
        listed = request(sock, {"cmd": "stream_list"})
        assert listed["ok"] and listed["sessions"][sid]["alive"]
        for _ in range(3000):  # a paced block or more before the stop
            if request(sock, {"cmd": "stream_status"})["blocks"] >= 4:
                break
            time.sleep(0.01)
    finally:
        stats = request(sock, {"cmd": "stream_stop"})
    assert stats["ok"] and stats["blocks"] > 0, stats
    got, sr = read_wav(out)
    assert sr == config.sample_rate and got.shape[0] == stats["blocks"] * 128
    assert np.isfinite(got).all()
    # stopping again and moving with no session: clean errors
    assert "no active stream session" in request(sock, {"cmd": "stream_stop"})["error"]
    assert not request(sock, {"cmd": "move", "azi": 0})["ok"]
    assert not request(sock, {"cmd": "stream_status", "session": "nope"})["ok"]


def test_move_after_the_session_ended_is_refused(daemon, wav, tmp_path):
    sock, service = daemon
    resp = request(sock, {"cmd": "stream_start", "input": str(wav),
                          "output": str(tmp_path / "o.wav"), "seconds": 0.02,
                          "paced": False})
    sid = resp["session"]
    _wait_ended(service, sid)
    mv = request(sock, {"cmd": "move", "session": sid, "azi": 10})
    assert not mv["ok"] and "ended" in mv["error"]
    assert request(sock, {"cmd": "stream_stop", "session": sid})["ok"]


def test_live_viz_watch_draws_a_session(daemon, wav, tmp_path):
    from jefferson_tpu_torch.viz.live import watch

    sock, _ = daemon
    svg = tmp_path / "live.svg"
    resp = request(sock, {"cmd": "stream_start", "input": str(wav),
                          "output": str(tmp_path / "o.wav"), "seconds": 8, "paced": True})
    assert resp["ok"], resp
    try:
        request(sock, {"cmd": "move", "azi": 90, "ele": 0, "r": 1.0})
        status = watch(sock, svg, interval_s=0.01, max_polls=5, three_d=True)
        assert status["ok"], status
        assert "azi 90" in svg.read_text()
        assert svg.with_suffix(".html").exists() and svg.with_suffix(".3d.html").exists()
        assert svg.with_suffix(".js").read_text().startswith("window.JT3D_STATE = {")
    finally:
        assert request(sock, {"cmd": "stream_stop"})["ok"]
    assert not watch(sock, svg, interval_s=0.01, max_polls=3).get("ok")


def test_ping_and_stats(daemon):
    sock, _ = daemon
    assert request(sock, {"cmd": "ping", "id": 3}) == {"id": 3, "ok": True, "pong": True}
    st = request(sock, {"cmd": "stats"})
    assert st["ok"] and {"renders", "blocks", "seconds", "errors", "launches"} <= set(st)
    # the CPU runs the twins: no kernel launches
    assert st["launches"] == {}


@pytest.mark.parametrize("req,match", [
    ({"cmd": [1]}, "cmd must be a string"),
    ({"cmd": "nope"}, "unknown cmd 'nope'"),
    ({"cmd": "render", "input": "x.wav", "output": "y.wav", "blocks": 0},
     r"blocks \(0\) must be positive"),
    ({"cmd": "render", "input": "x.wav", "output": "y.wav", "duration": 0},
     r"duration \(0.0\) must be positive"),
    ({"cmd": "stream_start", "input": "x.wav", "output": "y.wav", "seconds": 0},
     "seconds must be > 0"),
    ({"cmd": "stream_start", "input": "x.wav", "output": "y.wav", "blocks": 4},
     "takes 'seconds', not 'blocks'"),
    ({"cmd": "render", "input": "absent.wav", "output": "y.wav"}, "FileNotFoundError"),
])
def test_handle_error_replies(daemon, wav, tmp_path, req, match):
    sock, _ = daemon
    req = {k: (str(wav) if v == "x.wav" else str(tmp_path / v) if k == "output" else v)
           for k, v in req.items()}
    resp = request(sock, req)
    assert resp["ok"] is False
    assert re.search(match, resp["error"]), resp


def test_bad_json_and_non_object_requests(daemon):
    sock, _ = daemon
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(30)
        s.connect(str(sock))
        s.sendall(b"{not json\n[1, 2]\n\"x\"\n{\"cmd\": \"ping\"}\n")
        buf = b""
        while buf.count(b"\n") < 4:
            buf += s.recv(65536)
    replies = [json.loads(line) for line in buf.decode().splitlines()]
    assert "bad json" in replies[0]["error"]
    assert replies[1]["error"] == "request must be a JSON object, got list"
    assert replies[2]["error"] == "request must be a JSON object, got str"
    assert replies[3]["pong"]


def test_too_many_sessions(daemon, wav, tmp_path):
    sock, service = daemon
    saved = service.max_streams
    service.max_streams = 0
    try:
        resp = request(sock, {"cmd": "stream_start", "input": str(wav),
                              "output": str(tmp_path / "o.wav")})
    finally:
        service.max_streams = saved
    assert not resp["ok"] and "too many active stream sessions (0)" in resp["error"]


def test_shutdown_stops_sessions_and_refuses_new_ones(wav, tmp_path):
    """A service of its own: shutdown quits and joins a live session, then
    a stream_start is refused."""
    service = RenderService(chunk_blocks=64, device="cpu")
    resp = service.handle({"cmd": "stream_start", "input": str(wav),
                           "output": str(tmp_path / "o.wav"), "seconds": 30.0,
                           "paced": True})
    assert resp["ok"], resp
    down = service.handle({"cmd": "shutdown"})
    assert down["ok"] and down["stopped_sessions"] == [resp["session"]]
    assert "pending_sessions" not in down
    late = service.handle({"cmd": "stream_start", "input": str(wav),
                           "output": str(tmp_path / "p.wav")})
    assert not late["ok"] and late["error"] == "daemon is shutting down"
    assert read_wav(tmp_path / "o.wav")[0].shape[1] == 2  # the writer flushed


def test_serve_socket_exits_on_shutdown(tmp_path):
    service = RenderService(chunk_blocks=64, device="cpu")
    sock = tmp_path / "s.sock"
    t = threading.Thread(target=serve, args=(sock, service), daemon=True)
    t.start()
    _wait_socket(sock)
    assert request(sock, {"cmd": "shutdown"})["shutdown"]
    t.join(timeout=10)
    assert not t.is_alive() and not sock.exists()


def test_devices_above_one_refused_naming_item_9():
    """A service of 2 devices outside a world of 2 ranks raises make_mesh's
    message (the meshed daemon itself: tests/test_torch_serve_mesh.py)."""
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        RenderService(devices=2, device="cpu")
    with pytest.raises(SystemExit, match=r"chunk_blocks \(2047\) must divide evenly over "
                                         r"devices \(2\)"):
        tserve.main(["--devices", "2", "--chunk-blocks", "2047", "--device", "cpu",
                     "--socket", "unused.sock"])


def test_cli_refuses_bad_chunk_blocks_and_no_card():
    with pytest.raises(SystemExit, match="must be a positive block count"):
        tserve.main(["--chunk-blocks", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="is_available"):
            tserve.main(["--socket", "unused.sock"])


def test_cli_request_mode(daemon, capsys):
    sock, _ = daemon
    assert tserve.main(["--socket", str(sock), "--request", '{"cmd": "ping"}']) == 0
    assert '"pong": true' in capsys.readouterr().out
    assert tserve.main(["--socket", str(sock), "--request", '{"cmd": "nope"}']) == 1


def test_warm_up_builds_the_libraries_and_renders_before_the_first_request(monkeypatch):
    """At start a service builds the libraries its paths launch (on the
    card only: spied here, with no card) and renders a few blocks."""
    from jefferson_tpu_torch.engine.renderer import Renderer
    from jefferson_tpu_torch.kernels import build

    built = []
    monkeypatch.setattr(build, "build_all",
                        lambda names, geometries: built.append((tuple(names), geometries)))
    svc = RenderService.__new__(RenderService)
    svc.device = torch.device("cpu")
    svc.rank, svc.mesh = 0, None
    svc.db = synthetic_database()
    svc.config = svc.db.config
    svc.renderer = Renderer(svc.db, device="cpu")
    svc._warm()
    assert built == [] and len(svc.renderer.dispatch) == 1
    svc.device = torch.device("cuda", 0)
    with pytest.raises(Exception):  # the live step's prime: no card here
        svc._warm()
    assert built == [(tserve.LIBRARIES, [(128, 1024)])]


def test_live_sessions_script_runs_each_mode(capsys):
    """scripts/live_sessions.py: a daemon process a run, its sessions with
    the turns and free of them, in turns."""
    from jefferson_tpu_torch.scripts import live_sessions

    assert live_sessions.main(["--device", "cpu", "--sessions", "1", "--seconds", "0.1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["mode"] for r in res["runs"]] == list(live_sessions.MODES)
    assert all(r["sessions"][0]["blocks"] == 35 for r in res["runs"])


def test_paced_sessions_start_on_spread_phases():
    """Session k's block clock starts at phase 0, 1/2, 1/4, 3/4, 1/8, ... of
    a block on the daemon's grid (3-bit reversal of k), within a period."""
    svc = RenderService.__new__(RenderService)
    svc.config = synthetic_database().config
    period = svc.config.block_duration
    svc._epoch = time.perf_counter()
    phases = []
    for k in range(9):
        delay = svc._phase_delay(k)
        assert 0 <= delay < period
        phases.append(round(((time.perf_counter() + delay - svc._epoch) % period) / period * 8))
    assert [p % 8 for p in phases] == [0, 4, 2, 6, 1, 5, 3, 7, 0]
