"""The live loop's host modules in the port: ``OracleSpatializer``,
``io.wavio`` and ``rt.control`` pinned bit for bit to the JAX package's
originals on seeded inputs, and the cases of tests/test_playout.py and
tests/test_control.py that need no sound card and no TTY, run against the
port's ``AudioPlayout`` and ``StreamingSpatializer(device="cpu")``.

The JAX ``io.wavio`` takes its native extension where it is built; the
port's copy is its NumPy arm, so the pins hold the copy to that arm (with
the extension switched off), and tests/test_wavio.py holds the two arms
within one LSB of each other.
"""

import dataclasses
import struct
import time

import numpy as np
import pytest
import torch

from jefferson_tpu.config import ProcessType as JProcessType
from jefferson_tpu.io import wavio as jwavio
from jefferson_tpu.oracle import reference as jref
from jefferson_tpu.rt import control as jcontrol
from jefferson_tpu.testing import precision_check
from jefferson_tpu_torch.config import ProcessType
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.engine.stream import StreamingSpatializer
from jefferson_tpu_torch.io import wavio as twavio
from jefferson_tpu_torch.io.wavio import StreamingWavWriter, read_wav
from jefferson_tpu_torch.oracle import reference as tref
from jefferson_tpu_torch.rt import control as tcontrol
from jefferson_tpu_torch.rt import playout as tplayout
from jefferson_tpu_torch.rt.control import INITIAL_XYZ, KEY_STEP, RESET_XYZ, SourceControl
from jefferson_tpu_torch.rt.playout import AudioPlayout, BlockStats, have_output_device
from jefferson_tpu_torch.trajectory.spatial import cartesian_to_spherical

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


def _equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---- OracleSpatializer ---------------------------------------------------------

@pytest.mark.parametrize("ptype", ["CPU_FD_COMPLEX", "TPU_FD_BASIC", "CPU_TD", "TPU_TD"])
def test_oracle_spatializer_is_equal(db, tdb, ptype):
    """Both classes through one script: spherical and cartesian updates,
    a playback buffer shorter than the render (the playhead wraps), direct
    feeds, each process type, the TD gain; every output and every piece of
    state equal."""
    rng = np.random.default_rng(4)
    jo, to = jref.OracleSpatializer(db, db.config), tref.OracleSpatializer(tdb, tdb.config)
    buf = (rng.standard_normal(1000) * 0.3).astype(np.float32)
    for o in (jo, to):
        o.buf = buf
        o.td_gain = 0.5 if ptype == "TPU_TD" else 1.0
    for b in range(14):
        if b % 4 == 3:
            xyz = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
            jo.update_from_cartesian(xyz)
            to.update_from_cartesian(xyz)
        else:
            e, a, r = rng.uniform(-40, 90), rng.uniform(-20, 380), rng.uniform(0.2, 2)
            jo.update_from_spherical(ele=e, azi=a, r=r if b % 2 else None)
            to.update_from_spherical(ele=e, azi=a, r=r if b % 2 else None)
        if b % 5 == 4:
            blk = (rng.standard_normal(128) * 0.2).astype(np.float32)
            jo.feed_block(blk)
            to.feed_block(blk)
        else:
            jo.feed_from_buf()
            to.feed_from_buf()
        got = to.process(ProcessType[ptype])
        want = jo.process(JProcessType[ptype])
        _equal(got, want, f"block {b}")
        jo.overlap_save()
        to.overlap_save()
        for attr in ("x", "azi", "ele", "r", "coordinates", "old_azi", "old_ele", "count",
                     "hrtf_idx"):
            _equal(getattr(to, attr), getattr(jo, attr), f"{attr} after block {b}")


@pytest.mark.parametrize("ptype,td_gain", [("CPU_FD_BASIC", 1.0), ("TPU_TD", 0.25)])
def test_render_oracle_is_equal_for_every_process_type(db, tdb, ptype, td_gain):
    rng = np.random.default_rng(8)
    pos = [tuple(p) for p in np.stack([rng.uniform(0, 360, 12), rng.uniform(-40, 90, 12),
                                       rng.uniform(0.3, 2, 12)], axis=1)]
    sig = (rng.standard_normal(1500) * 0.3).astype(np.float32)
    got = tref.render_oracle(sig, tdb, pos, tdb.config, ProcessType[ptype], td_gain=td_gain)
    want = jref.render_oracle(sig, db, pos, db.config, JProcessType[ptype], td_gain=td_gain)
    _equal(got, want)


# ---- io.wavio ------------------------------------------------------------------

def _wav(fmt_body: bytes, data: bytes) -> bytes:
    body = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


@pytest.mark.parametrize("bits,float_format", [(16, False), (24, False), (32, False),
                                               (32, True), (64, True)])
@pytest.mark.parametrize("channels,frames,dtype", [(1, 257, np.float32), (2, 1000, np.float64)])
def test_wavio_writes_and_reads_the_same_bytes(tmp_path, monkeypatch, bits, float_format,
                                               channels, frames, dtype):
    monkeypatch.setattr(jwavio, "_nat", None)
    rng = np.random.default_rng(bits + channels)
    x = (rng.random((frames, channels)) * 2.4 - 1.2).astype(dtype)
    x[0, 0], x[-1, -1] = 1.0, -1.0
    if channels == 1:
        x = x[:, 0]
    pj, pt = tmp_path / "j.wav", tmp_path / "t.wav"
    jwavio.write_wav(pj, x, 44100, bits=bits, float_format=float_format)
    twavio.write_wav(pt, x, 44100, bits=bits, float_format=float_format)
    assert pt.read_bytes() == pj.read_bytes()
    for rd in (np.float32, np.float64):
        for read in ("read_wav", "read_wav_mono"):
            got, sr = getattr(twavio, read)(pj, dtype=rd)
            want, wsr = getattr(jwavio, read)(pj, dtype=rd)
            assert sr == wsr == 44100
            _equal(got, want, f"{read} {rd}")
    assert twavio.read_wav_info(pj) == twavio.WavInfo(**dataclasses.asdict(jwavio.read_wav_info(pj)))
    assert twavio.resolve_float_bits(bits, float_format) == jwavio.resolve_float_bits(bits, float_format)


def test_wavio_streaming_writer_writes_the_same_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(jwavio, "_nat", None)
    rng = np.random.default_rng(3)
    blocks = [(rng.random((n, 2)) * 2 - 1).astype(np.float32) for n in (128, 128, 77, 1)]
    paths = {}
    for name, mod in (("j", jwavio), ("t", twavio)):
        paths[name] = tmp_path / f"{name}.wav"
        with mod.StreamingWavWriter(paths[name], 48000, channels=2, bits=24) as w:
            for i, blk in enumerate(blocks):
                w.write(blk)
                if i == 1:
                    w.flush()
    assert paths["t"].read_bytes() == paths["j"].read_bytes()
    with pytest.raises(ValueError, match="expected 2 channels"):
        twavio.StreamingWavWriter(tmp_path / "x.wav", 44100).write(np.zeros(4, np.float32))


@pytest.mark.parametrize("case", ["u8", "extensible", "truncated_data", "odd_pad"])
def test_wavio_reads_hand_made_files_the_same(tmp_path, monkeypatch, case):
    monkeypatch.setattr(jwavio, "_nat", None)
    raw = bytes([0, 64, 128, 192, 255, 7, 99, 200, 13])
    fmt = {
        "u8": struct.pack("<HHIIHH", 1, 1, 22050, 22050, 1, 8),
        "extensible": (struct.pack("<HHIIHH", 0xFFFE, 1, 44100, 88200, 2, 16)
                       + struct.pack("<HHI", 22, 16, 0x4) + struct.pack("<H", 1) + bytes(14)),
        "truncated_data": struct.pack("<HHIIHH", 1, 2, 44100, 264600, 6, 24),
        "odd_pad": struct.pack("<HHIIHH", 3, 1, 8000, 32000, 4, 32),
    }[case]
    data = raw[:8] if case == "odd_pad" else raw
    p = tmp_path / f"{case}.wav"
    p.write_bytes(_wav(fmt, data))
    for dtype in (np.float32, np.float64):
        got, sr = twavio.read_wav(p, dtype=dtype)
        want, wsr = jwavio.read_wav(p, dtype=dtype)
        assert sr == wsr
        _equal(got, want, f"{case} {dtype}")


@pytest.mark.parametrize("fmt,match", [
    (struct.pack("<HHIIHH", 6, 1, 8000, 8000, 1, 8), "unsupported WAVE format"),
    (struct.pack("<HHIIHH", 1, 1, 8000, 12000, 2, 12), "bit depth"),
    (struct.pack("<HHIIHH", 1, 0, 8000, 8000, 1, 8), "channels=0"),
    (struct.pack("<HHI", 1, 1, 8000), "truncated fmt"),
    (struct.pack("<HHIIHH", 0xFFFE, 1, 44100, 88200, 2, 16), "EXTENSIBLE"),
])
def test_wavio_refuses_what_the_original_refuses(tmp_path, monkeypatch, fmt, match):
    monkeypatch.setattr(jwavio, "_nat", None)
    p = tmp_path / "bad.wav"
    p.write_bytes(_wav(fmt, bytes(16)))
    with pytest.raises(ValueError, match=match) as got:
        twavio.read_wav(p, dtype=np.float64)
    with pytest.raises(ValueError) as want:
        jwavio.read_wav(p, dtype=np.float64)
    assert str(got.value) == str(want.value)
    for mod in (twavio, jwavio):
        with pytest.raises(ValueError, match="not a RIFF"):
            mod.read_wav_info(_write(tmp_path / "junk.wav", b"RIFX0000WAVE"))
        with pytest.raises(ValueError, match="4 GiB RIFF limit"):
            mod._header(44100, 2, 24, False, 0xFFFFFFFF - 8)


def _write(path, data: bytes):
    path.write_bytes(data)
    return path


# ---- rt.control ----------------------------------------------------------------

def test_control_keys_match_the_original():
    """Seeded key sequences drive both SourceControls to the same states,
    the -40 degree guard included."""
    rng = np.random.default_rng(9)
    keys = ["w", "s", "a", "d", "W", "S", "A", "D", "left", "right", "up", "down", "r", "x"]
    for trial in range(20):
        start = tuple(rng.uniform(-1, 1, 3))
        t, j = tcontrol.SourceControl(start), jcontrol.SourceControl(start)
        for key in rng.choice(keys, 200):
            assert t.apply_key(key) == j.apply_key(key)
            assert t.coordinates() == j.coordinates() and t.moves == j.moves, (trial, key)
        assert t.apply_key("q") is j.apply_key("q") is False
        assert t.quit and j.quit
    assert (tcontrol.KEY_STEP, tcontrol.INITIAL_XYZ, tcontrol.RESET_XYZ) == \
        (jcontrol.KEY_STEP, jcontrol.INITIAL_XYZ, jcontrol.RESET_XYZ)


def test_control_decoding_and_xyz_match_the_original():
    rng = np.random.default_rng(10)
    alphabet = np.frombuffer(b"\x1b[OA1;2~BCDwasdq[Hxyz", np.uint8)
    for _ in range(300):
        data = bytes(rng.choice(alphabet, int(rng.integers(0, 12))).tolist())
        assert tcontrol.decode_keys_partial(data) == jcontrol.decode_keys_partial(data)
        assert tcontrol.decode_keys(data) == jcontrol.decode_keys(data)
    for azi in np.arange(-30.0, 390.0, 17.5):
        for ele in (-40.0, -3.0, 0.0, 12.5, 89.0):
            assert tcontrol.spherical_to_control_xyz(azi, ele, 0.9) == \
                jcontrol.spherical_to_control_xyz(azi, ele, 0.9)


# ---- tests/test_playout.py's cases on the port ---------------------------------

def _src(tdb, tconfig, castanets, azi=30.0, roll=0):
    s = StreamingSpatializer(tdb, tconfig, device="cpu")
    s.set_position(azi=azi, ele=0, r=1.0)
    s.buf = np.roll(castanets, roll)[:4000].astype(np.float32)
    return s


def test_offline_playout_mixes_and_writes(tdb, castanets, tmp_path):
    """Fake-device loop == sum of per-source streams; WAV appended per block."""
    cfg = tdb.config
    nb = 40
    wav = tmp_path / "live.wav"
    writer = StreamingWavWriter(wav, cfg.sample_rate, bits=24)
    srcs = [_src(tdb, cfg, castanets), _src(tdb, cfg, castanets, azi=300.0, roll=500)]
    play = AudioPlayout(srcs, cfg, writer=writer)
    stats = play.run_offline(nb)
    writer.close()
    assert stats.blocks == nb
    assert stats.budget_ms == pytest.approx(1e3 * cfg.frames_per_buffer / cfg.sample_rate)
    assert stats.avg_ms > 0 and stats.max_ms >= stats.avg_ms >= 0
    want = np.zeros((nb * cfg.frames_per_buffer, 2), np.float32)
    for azi, roll in [(30.0, 0), (300.0, 500)]:
        s = _src(tdb, cfg, castanets, azi=azi, roll=roll)
        for b in range(nb):
            want[b * cfg.frames_per_buffer : (b + 1) * cfg.frames_per_buffer] += s.process_next()
    got, sr = read_wav(wav)
    assert sr == cfg.sample_rate
    rep = precision_check(got, want, eps=2e-7)  # 24-bit quantization floor
    assert rep.ok, str(rep)


def test_prime_does_not_mutate_state(tdb, castanets):
    a, b = _src(tdb, tdb.config, castanets), _src(tdb, tdb.config, castanets)
    a.prime()
    for _ in range(5):
        rep = precision_check(a.process_next(), b.process_next(), eps=0.0)
        assert rep.ok, str(rep)


def test_deadline_miss_accounting(tdb):
    """A source slower than the block budget is counted as a miss."""
    cfg = tdb.config

    def slow():
        time.sleep(cfg.block_duration * 1.5)
        return np.zeros((cfg.frames_per_buffer, 2), np.float32)

    stats = AudioPlayout([slow], cfg).run_offline(3)
    assert stats.blocks == 3 and stats.misses == 3 and stats.miss_rate == 1.0
    assert stats.max_ms > stats.budget_ms
    assert "deadline misses" in stats.summary()


def test_paced_run_holds_cadence(tdb):
    """Paced mode takes at least num_blocks * block_duration of wall time."""
    cfg = tdb.config
    play = AudioPlayout([lambda: np.zeros((cfg.frames_per_buffer, 2), np.float32)], cfg)
    t0 = time.perf_counter()
    play.run_offline(20, paced=True)
    assert time.perf_counter() - t0 >= 19 * cfg.block_duration


def test_clipping_alert(tdb):
    cfg = tdb.config
    play = AudioPlayout([lambda: np.full((cfg.frames_per_buffer, 2), 1.5, np.float32)], cfg)
    play.run_offline(1)
    assert play.clipping


def test_play_degrades_gracefully(tdb, castanets, monkeypatch):
    """Without sounddevice, play() raises a clear error and the probe
    reports unavailability."""
    monkeypatch.setattr(tplayout, "_sounddevice", lambda: None)
    assert not have_output_device()
    play = AudioPlayout([_src(tdb, tdb.config, castanets)], tdb.config)
    with pytest.raises(RuntimeError, match="sounddevice|output device"):
        play.play(num_blocks=2)


def test_playout_requires_sources(tdb):
    with pytest.raises(ValueError):
        AudioPlayout([], tdb.config)


def test_playout_takes_the_config_of_its_first_spatializer(tdb, castanets):
    play = AudioPlayout([_src(tdb, tdb.config, castanets)])
    assert play.config is tdb.config
    assert play.stats == BlockStats(budget_ms=1e3 * tdb.config.block_duration)


def test_position_caches_bounded(tdb, castanets):
    """A continuously varying position must not grow the memos unboundedly."""
    s = _src(tdb, tdb.config, castanets)
    s._CACHE_CAP = 16
    for b in range(64):
        s.set_position(azi=(b * 7) % 360, ele=0, r=1.0 + 0.001 * b)
        s.process_next()
    assert len(s._dist_cache) <= 16
    assert len(s._interp_cache) <= 16


def test_prime_through_wrapper(tdb, castanets):
    """AudioPlayout primes duck-typed sources (wrapper carrying .prime)."""
    s = _src(tdb, tdb.config, castanets)
    primed = {"n": 0}

    def wrapper():
        return s.process_next()

    def prime():
        primed["n"] += 1
        s.prime()

    wrapper.prime = prime
    AudioPlayout([wrapper], tdb.config).run_offline(2)
    assert primed["n"] == 1


class _FakeSD:
    """Minimal sounddevice stand-in: a blocking OutputStream that drives the
    registered callback synchronously (frames overridable to test the
    blocksize guard)."""

    class CallbackStop(Exception):
        pass

    class CallbackAbort(Exception):
        pass

    def __init__(self, frames=None):
        self._frames = frames
        self.last_outdata = None

    def OutputStream(self, samplerate, blocksize, channels, dtype, callback,
                     finished_callback, device):
        fake = self

        class _Stream:
            def __enter__(self):
                for _ in range(100_000):  # bounded: a missing stop fails, not hangs
                    out = np.full((blocksize, channels), np.nan, np.float32)
                    try:
                        callback(out, fake._frames or blocksize, None, None)
                    except (fake.CallbackStop, fake.CallbackAbort):
                        fake.last_outdata = out
                        break
                else:
                    raise AssertionError("fake device callback never raised CallbackStop")
                finished_callback()
                return self

            def __exit__(self, *exc):
                return False

        return _Stream()


def test_play_through_fake_sounddevice(tdb, castanets, monkeypatch):
    """play() drives the device callback to num_blocks, zero-fills the final
    (post-stop) buffer instead of emitting garbage, and returns the stats."""
    fake = _FakeSD()
    monkeypatch.setattr(tplayout, "_sounddevice", lambda: fake)
    stats = AudioPlayout([_src(tdb, tdb.config, castanets)], tdb.config).play(num_blocks=3)
    assert stats.blocks == 3
    assert fake.last_outdata is not None
    np.testing.assert_array_equal(fake.last_outdata, 0.0)


def test_play_blocksize_mismatch_surfaces(tdb, castanets, monkeypatch):
    monkeypatch.setattr(tplayout, "_sounddevice", lambda: _FakeSD(frames=64))
    play = AudioPlayout([_src(tdb, tdb.config, castanets)], tdb.config)
    with pytest.raises(RuntimeError, match="device blocksize 64"):
        play.play(num_blocks=3)


def test_play_source_error_surfaces(tdb, monkeypatch):
    monkeypatch.setattr(tplayout, "_sounddevice", lambda: _FakeSD())

    def boom():
        raise ValueError("synthetic source failure")

    with pytest.raises(ValueError, match="synthetic source failure"):
        AudioPlayout([boom], tdb.config).play(num_blocks=2)


def test_have_output_device_probe_arms(monkeypatch):
    class SD:
        def __init__(self, chans=2, err=None):
            self.chans, self.err = chans, err

        def query_devices(self, kind=None):
            if self.err:
                raise self.err
            return {"max_output_channels": self.chans}

    monkeypatch.setattr(tplayout, "_sounddevice", lambda: SD(2))
    assert tplayout.have_output_device()
    monkeypatch.setattr(tplayout, "_sounddevice", lambda: SD(0))
    assert not tplayout.have_output_device()
    monkeypatch.setattr(tplayout, "_sounddevice", lambda: SD(err=RuntimeError("no backend")))
    assert not tplayout.have_output_device()
    monkeypatch.setattr(tplayout, "_sounddevice", lambda: None)
    assert not tplayout.have_output_device()


# ---- tests/test_control.py's cases on the port ---------------------------------

def test_key_steps_match_reference():
    c = SourceControl()
    assert c.coordinates() == INITIAL_XYZ
    assert c.apply_key("w")
    assert np.isclose(c.coordinates()[1], KEY_STEP)
    c.apply_key("s")
    c.apply_key("s")
    assert np.isclose(c.coordinates()[1], -KEY_STEP)
    c.apply_key("d")
    assert np.isclose(c.coordinates()[0], KEY_STEP)
    c.apply_key("left")
    c.apply_key("left")
    assert np.isclose(c.coordinates()[0], -KEY_STEP)
    c.apply_key("up")
    assert np.isclose(c.coordinates()[2], 0.5 - KEY_STEP)
    c.apply_key("down")
    assert np.isclose(c.coordinates()[2], 0.5)


def test_reset_quirk_and_quit():
    c = SourceControl()
    c.apply_key("w")
    c.apply_key("d")
    assert c.apply_key("r")
    assert c.coordinates() == RESET_XYZ  # differs from the constructor state
    assert not c.apply_key("q") and c.quit
    c2 = SourceControl()
    assert not c2.apply_key("esc") and c2.quit


def test_elevation_guard_minus_40():
    c = SourceControl()
    for _ in range(200):
        c.apply_key("s")
    ele = float(cartesian_to_spherical(np.asarray(c.coordinates()))[1])
    assert ele >= -40.0
    before, moves_before = c.coordinates(), c.moves
    c.apply_key("a")
    ele2 = float(cartesian_to_spherical(np.asarray(c.coordinates()))[1])
    assert ele2 >= -41.0
    if c.moves == moves_before:
        assert c.coordinates() == before


def test_decode_keys():
    d = tcontrol.decode_keys
    assert d(b"wasd") == ["w", "a", "s", "d"]
    assert d(b"\x1b[A\x1b[B\x1b[C\x1b[D") == ["up", "down", "right", "left"]
    assert d(b"\x1b") == ["esc"]
    assert d(b"r\x1b[Aq") == ["r", "up", "q"]
    assert d(b"\x1bOC") == ["right"]


def test_decode_keys_partial_never_misreads_esc():
    """A held arrow split across reads is no quit; unknown escape sequences
    are consumed whole."""
    keys, rest = tcontrol.decode_keys_partial(b"\x1b[A" * 5 + b"\x1b")
    assert keys == ["up"] * 5 and rest == b"\x1b"
    assert tcontrol.decode_keys_partial(rest + b"[A") == (["up"], b"")
    assert tcontrol.decode_keys(b"\x1b[1;2A") == []
    assert tcontrol.decode_keys(b"\x1b[H\x1b[15~w") == ["w"]
    assert tcontrol.decode_keys_partial(b"d\x1b[1;2") == (["d"], b"\x1b[1;2")
    assert tcontrol.decode_keys(b"\x1bw") == ["esc", "w"]


def test_quit_requires_explicit_esc():
    c = SourceControl()
    for key in tcontrol.decode_keys(b"\x1b[1;2A\x1b[Z\x1b[5~"):
        c.apply_key(key)
    assert not c.quit


def test_linux_console_fkeys_ignored():
    for letter in b"ABCDE":
        assert tcontrol.decode_keys(b"\x1b[[" + bytes([letter])) == []
    assert tcontrol.decode_keys(b"w\x1b[[Ad") == ["w", "d"]
    assert tcontrol.decode_keys_partial(b"\x1b[[") == ([], b"\x1b[[")
    assert tcontrol.decode_keys_partial(b"\x1b[[Bs") == (["s"], b"")


def test_interactive_playout_crossfades_and_deadline(tdb, castanets):
    """Position commands injected between blocks of a fake-device playout
    fire crossfades, and the average block stays inside a relaxed multiple
    of the realtime budget (the in-suite smoke of tests/test_control.py;
    the strict gate runs on the card, tests/test_torch_cuda.py)."""
    cfg = tdb.config
    control = SourceControl()
    spat = StreamingSpatializer(tdb, cfg, device="cpu")
    signal = castanets[:8000]
    fpb, n_sig = cfg.frames_per_buffer, len(signal)
    state = {"i": 0, "b": 0}
    schedule = {3: ["d", "d"], 6: ["w"], 9: ["up", "a"], 12: ["r"]}

    def source():
        for key in schedule.get(state["b"], []):
            control.apply_key(key)
        state["b"] += 1
        spat.set_position_cartesian(control.coordinates())
        idx = (np.arange(fpb) + state["i"]) % n_sig
        state["i"] += fpb
        return spat.process_block(signal[idx])

    source.prime = spat.prime
    play = AudioPlayout([source], cfg)
    stats = play.run_offline(16, stop=lambda: control.quit)
    assert stats.blocks == 16
    assert spat.crossfades >= 3, "position commands must trigger crossfades"
    assert stats.avg_ms < 3 * stats.budget_ms, stats.summary()
    assert not play.clipping


def test_interactive_quit_stops_loop(tdb, castanets):
    cfg = tdb.config
    control = SourceControl()
    spat = StreamingSpatializer(tdb, cfg, device="cpu")
    state = {"b": 0}

    def source():
        state["b"] += 1
        if state["b"] == 5:
            control.apply_key("q")
        spat.set_position_cartesian(control.coordinates())
        return spat.process_block(castanets[: cfg.frames_per_buffer])

    source.prime = spat.prime
    stats = AudioPlayout([source], cfg).run_offline(100, stop=lambda: control.quit)
    assert stats.blocks == 5


def _key_loop(control, r, **kw):
    import threading

    t = threading.Thread(target=tcontrol.tty_key_loop, args=(control, r), kwargs=kw, daemon=True)
    t.start()
    return t


def test_keythread_close_stops_reader():
    """The stop event ends the TTY reader on a pipe without quitting."""
    import os
    import threading

    r, w = os.pipe()
    try:
        control, stop = SourceControl(), threading.Event()
        t = _key_loop(control, r, stop=stop)
        os.write(w, b"d")
        time.sleep(0.15)
        assert control.moves == 1
        stop.set()
        t.join(timeout=1.0)
        assert not t.is_alive() and not control.quit
    finally:
        os.close(r)
        os.close(w)


def test_tty_key_loop_over_pipe():
    """The key loop over a plain pipe: keys apply, a CSI split across reads
    survives one timeout window, a lone ESC quits after two empty windows."""
    import os

    keys_seen = []
    c = SourceControl()
    r, w = os.pipe()
    t = _key_loop(c, r, on_key=lambda k, xyz: keys_seen.append(k))
    try:
        os.write(w, b"w")
        deadline = time.time() + 2.0
        while "w" not in keys_seen and time.time() < deadline:
            time.sleep(0.01)
        assert np.isclose(c.coordinates()[1], KEY_STEP)
        os.write(w, b"\x1b[")
        time.sleep(0.08)
        os.write(w, b"C")
        deadline = time.time() + 2.0
        while "right" not in keys_seen and time.time() < deadline:
            time.sleep(0.01)
        assert np.isclose(c.coordinates()[0], KEY_STEP)
        os.write(w, b"\x1b")
        t.join(timeout=3.0)
        assert not t.is_alive() and c.quit
    finally:
        os.close(w)
        os.close(r)


def test_tty_key_loop_stop_event():
    import os
    import threading

    c, stop = SourceControl(), threading.Event()
    r, w = os.pipe()
    t = _key_loop(c, r, stop=stop)
    stop.set()
    t.join(timeout=3.0)
    assert not t.is_alive() and not c.quit
    os.close(w)
    os.close(r)


def test_keythread_pty_owns_terminal_state(monkeypatch):
    """KeyThread over a pty the test opens: cbreak on construction, keys
    through the reader thread, and close() joins it and restores the
    original settings, twice without harm."""
    import os
    import pty
    import sys
    import termios
    import threading

    master, slave = pty.openpty()
    try:
        monkeypatch.setattr(sys, "stdin", os.fdopen(slave, "rb", buffering=0, closefd=False))
        assert termios.tcgetattr(slave)[3] & termios.ICANON
        c, seen, got_key = SourceControl(), [], threading.Event()

        def on_key(key, xyz):
            seen.append((key, xyz))
            got_key.set()

        with tcontrol.KeyThread(c, on_key=on_key) as kt:
            assert not (termios.tcgetattr(slave)[3] & termios.ICANON)
            os.write(master, b"w")
            assert got_key.wait(timeout=3.0), "key never reached the loop"
        assert seen and seen[0][0] == "w"
        assert not kt.thread.is_alive()
        assert termios.tcgetattr(slave)[3] & termios.ICANON
        kt.close()
    finally:
        os.close(master)
        os.close(slave)
