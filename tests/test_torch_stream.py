"""The port's streaming engine on the CPU: every case of tests/test_stream.py
with ``device="cpu"`` (the kernels' plain twins) on the JAX fixtures, held
with precision_check(eps=1e-6) against what each case holds the JAX module
to, and beside them the port against the JAX ``StreamingSpatializer`` and
``render_scan`` block by block (5e-7: the JAX step applies each filter
before the distance, the port after, so the two differ in rounding), the
no-crossfade step's bitwise contract, the shared table, and the refusals.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from jefferson_tpu.engine import stream as jstream
from jefferson_tpu.testing import precision_check
from jefferson_tpu.trajectory.trajectory import CircularOrbit
from jefferson_tpu_torch.config import EngineConfig
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.engine import stream as tstream
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.engine.plan import fed_stream
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.engine.stream import StreamingSpatializer, render_scan
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.oracle.reference import OracleSpatializer, render_oracle
from jefferson_tpu_torch.rt.control import spherical_to_control_xyz

torch.set_num_threads(1)

EPS = 1e-6       # tests/test_stream.py's gate
TOL_JAX = 5e-7   # the port against the JAX stream, block by block


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


@pytest.fixture(scope="module")
def tconfig(tdb):
    return tdb.config


def _spat(tdb, tconfig, **kw):
    return StreamingSpatializer(tdb, tconfig, device="cpu", **kw)


def test_scan_matches_batched(db, tdb, tconfig, castanets):
    pos = CircularOrbit(period_s=1.0, ele=3, r=1.2).sample(40, tconfig)
    got = render_scan(castanets, tdb, pos, tconfig, device="cpu")
    want = Renderer(tdb, chunk_blocks=64, device="cpu").render(castanets, pos)
    rep = precision_check(got, want, eps=EPS)
    assert rep.ok, str(rep)
    jax_scan = jstream.render_scan(castanets, db, pos, db.config)
    rep = precision_check(got, jax_scan, eps=TOL_JAX)
    assert rep.ok, str(rep)


def test_scan_chunks_carry_the_history(tdb, tconfig, castanets):
    """Chunks of the scan see the samples before them: any chunking renders
    the same bits as one launch, and the launches run as twins here."""
    pos = CircularOrbit(period_s=0.3, ele=8, r=0.9).sample(37, tconfig)
    before = dict(tfs.launches)
    whole = render_scan(castanets, tdb, pos, tconfig, device="cpu")
    chunked = render_scan(castanets, tdb, pos, tconfig, device="cpu", chunk_blocks=8)
    assert tfs.launches == before
    np.testing.assert_array_equal(chunked, whole)
    want = render_oracle(castanets, tdb, [tuple(p) for p in pos], tconfig, initial_old=None)
    got = render_scan(castanets, tdb, pos, tconfig, initial_old=None, device="cpu")
    rep = precision_check(got, want, eps=EPS)
    assert rep.ok, str(rep)
    with pytest.raises(ValueError, match="chunk_blocks"):
        render_scan(castanets, tdb, pos, tconfig, device="cpu", chunk_blocks=0)


def test_streaming_spatializer_matches_oracle(tdb, tconfig, castanets):
    """Live API: feed blocks while moving the source; equals the oracle."""
    sp = _spat(tdb, tconfig)
    sp.buf = castanets
    outs, positions = [], []
    azis = [0, 0, 5, 5, 10, 20, 20, 355, 355, 0]
    eles = [0, 0, 0, 4, 4, -10, -10, 8, 8, 0]
    for azi, ele in zip(azis, eles):
        sp.set_position(azi=azi, ele=ele, r=1.0)
        positions.append((float(azi), float(ele), 1.0))
        outs.append(sp.process_next())
    got = np.concatenate(outs)
    want = render_oracle(castanets, tdb, positions, tconfig)
    rep = precision_check(got, want, eps=EPS)
    assert rep.ok, str(rep)
    assert sp.crossfades == 6


def test_streaming_matches_the_jax_stream_block_by_block(db, tdb, tconfig, castanets):
    """64 blocks, the source moving every 3 blocks (azimuth, elevation and
    radius), against the JAX StreamingSpatializer's output per block."""
    rng = np.random.default_rng(7)
    port, jax = _spat(tdb, tconfig), jstream.StreamingSpatializer(db, db.config)
    for sp in (port, jax):
        sp.buf = castanets
    worst = 0.0
    for b in range(64):
        if b % 3 == 0:
            pos = dict(azi=float(rng.uniform(0, 360)), ele=float(rng.uniform(-40, 80)),
                       r=float(rng.uniform(0.3, 2.0)))
            port.set_position(**pos)
            jax.set_position(**pos)
        got, want = port.process_next(), jax.process_next()
        assert got.shape == want.shape == (tconfig.frames_per_buffer, 2)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"port vs JAX stream over 64 blocks: max|diff| = {worst:.3e} (limit {TOL_JAX:.0e})")
    assert worst <= TOL_JAX
    assert port.crossfades == jax.crossfades == 22


def test_held_blocks_take_the_no_crossfade_step(db, tdb, tconfig, castanets, monkeypatch):
    """Held blocks go through the no-crossfade step, moving blocks through
    the crossfade step, and the stream still matches the JAX
    StreamingSpatializer block by block."""
    held = []
    step_noxf = tstream._block_step_noxf
    monkeypatch.setattr(tstream, "_block_step_noxf",
                        lambda *a, **k: held.append(1) or step_noxf(*a, **k))
    port, jax = _spat(tdb, tconfig), jstream.StreamingSpatializer(db, db.config)
    for sp in (port, jax):
        sp.buf = castanets
    azis = [0, 0, 0, 30, 30, 35, 35, 35, 35, 200, 201, 201]
    worst = 0.0
    for azi in azis:
        for sp in (port, jax):
            sp.set_position(azi=azi, ele=5, r=0.7)
        got, want = port.process_next(), jax.process_next()
        worst = max(worst, float(np.abs(got - want).max()))
    # the first block moves from the start position (0, 0)
    assert port.crossfades == jax.crossfades == 5
    assert len(held) == len(azis) - 5
    assert worst <= TOL_JAX


def test_no_crossfade_step_is_bit_equal_on_held_blocks(tdb, tconfig):
    """The no-crossfade step equals the crossfade form with xf = 0 bit for
    bit, whatever the old brackets, history carried the same."""
    rng = np.random.default_rng(2)
    sp = _spat(tdb, tconfig)
    sp.set_position(azi=40, ele=10, r=0.8)
    idx, w = sp._interp(sp.ele, sp.azi)
    idx_o, w_o = sp._interp(np.float32(20), np.float32(-10))
    dist = sp._distance_current()
    off = tstream._xf_flag(torch.device("cpu"), False)
    table = sp._table
    hist_a = hist_b = torch.zeros(tconfig.history_len)
    for _ in range(4):
        blk = torch.from_numpy((rng.standard_normal(tconfig.frames_per_buffer) * 0.3)
                               .astype(np.float32))
        ya, hist_a = tstream._block_step(table, hist_a, blk, idx, w, idx_o, w_o, off, *dist,
                                         config=tconfig)
        yb, hist_b = tstream._block_step_noxf(table, hist_b, blk, idx, w, *dist, config=tconfig)
        assert torch.equal(ya, yb) and torch.equal(hist_a, hist_b)
        assert ya.shape == (2, tconfig.frames_per_buffer)


def test_streaming_cartesian_position(tdb, tconfig):
    sp = _spat(tdb, tconfig)
    sp.set_position_cartesian([1.0, 0.0, 0.0])  # +x -> azimuth 270 (reference convention)
    assert sp.azi == 270.0 and sp.ele == 0.0 and abs(sp.r - 1.0) < 1e-6
    sp.set_position_cartesian([0.0, 0.5, -0.5])
    assert sp.azi == 0.0 and sp.ele == 45.0


def test_streaming_clipping_flag(tdb, tconfig):
    sp = _spat(tdb, tconfig)
    loud = np.ones(tconfig.frames_per_buffer, np.float32) * 50.0
    for _ in range(8):  # let the filter ring build up
        sp.process_block(loud)
    assert sp.clipping


def test_pipeline_latency_mode(tdb, tconfig, castanets):
    """pipeline_latency=1 reproduces the reference GPU path's one-block
    delay: block 0 is silence, block k emits block k-1's result."""
    sync = _spat(tdb, tconfig)
    lat = _spat(tdb, tconfig, pipeline_latency=1)
    for sp in (sync, lat):
        sp.buf = castanets
        sp.set_position(azi=30, ele=0, r=1.0)
    a = [sync.process_next() for _ in range(5)]
    b = [lat.process_next() for _ in range(5)]
    np.testing.assert_array_equal(b[0], np.zeros_like(b[0]))
    for k in range(1, 5):
        np.testing.assert_array_equal(b[k], a[k - 1])


def test_block_step_shared_across_instances(db, tdb, tconfig, castanets):
    """Sessions on one device share ONE copy of the filter table per
    database, as the scan does; another database gets its own, and a
    dropped database releases its table."""
    a, b = _spat(tdb, tconfig), _spat(tdb, tconfig)
    assert a._table is b._table is tstream._device_table(tdb, "cpu")
    assert a._table.shape == (710, 4 * tconfig.num_bins)
    other = database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))
    assert _spat(other, tconfig)._table is not a._table
    key = (id(other), "cpu")
    assert key in tstream._TABLE_CACHE
    del other
    assert key not in tstream._TABLE_CACHE


def test_process_next_sub_block_buffer(tdb, tconfig):
    """A playback buffer SHORTER than one block tiles modularly (the
    reference's `% length` playhead generalized)."""
    fpb = tconfig.frames_per_buffer
    sp = _spat(tdb, tconfig)
    short = (np.sin(np.arange(50) / 3.0) * 0.1).astype(np.float32)
    sp.buf = short
    sp.set_position(azi=30, ele=0, r=1.0)
    outs = [sp.process_next() for _ in range(3)]
    assert all(o.shape == (fpb, 2) for o in outs)
    # the fed samples must equal fed_stream's tiling of the same signal
    want_fed = fed_stream(short, 3, tconfig)
    sp2 = _spat(tdb, tconfig)
    sp2.set_position(azi=30, ele=0, r=1.0)
    outs2 = [sp2.process_block(want_fed[i * fpb : (i + 1) * fpb]) for i in range(3)]
    np.testing.assert_array_equal(np.concatenate(outs), np.concatenate(outs2))


def test_process_next_wrap_unchanged_for_long_buffers(tdb, tconfig):
    """The modular wrap is value- and state-identical to the concatenating
    wrap for buffers longer than one block."""
    fpb = tconfig.frames_per_buffer
    sig = (np.sin(np.arange(fpb + 37) / 5.0) * 0.1).astype(np.float32)
    sp = _spat(tdb, tconfig)
    sp.buf = sig
    sp.set_position(azi=10, ele=5, r=0.8)
    fed, count = [], 0
    for _ in range(4):
        if count + fpb < len(sig):
            fed.append(sig[count : count + fpb])
            count += fpb
        else:
            rem = len(sig) - count
            fed.append(np.concatenate([sig[count:], sig[: fpb - rem]]))
            count = fpb - rem
        out = sp.process_next()
        assert out.shape == (fpb, 2)
        assert sp.count == count
    sp2 = _spat(tdb, tconfig)
    sp2.set_position(azi=10, ele=5, r=0.8)
    outs2 = [sp2.process_block(b) for b in fed]
    sp3 = _spat(tdb, tconfig)
    sp3.buf = sig
    sp3.set_position(azi=10, ele=5, r=0.8)
    outs3 = [sp3.process_next() for _ in range(4)]
    np.testing.assert_array_equal(np.concatenate(outs2), np.concatenate(outs3))


def test_cartesian_distance_uses_raw_coordinates(tdb, tconfig):
    """set_position_cartesian derives the distance factor from the RAW xyz
    (the oracle's update_from_cartesian semantics), not from the rounded
    angles, which would move the radius by an ulp."""
    from jefferson_tpu_torch.ops.filters import distance_phase_split
    from jefferson_tpu_torch.trajectory.spatial import radius_from_cartesian

    sp = _spat(tdb, tconfig)
    xyz = np.asarray([0.51, 0.0, 0.0], np.float32)
    sp.set_position_cartesian(xyz)
    uh, ul, df = (a.numpy() for a in sp._distance_current())
    scaled = np.float32(np.float32(radius_from_cartesian(xyz)) / np.float32(tconfig.distance_scale))
    wh, wl, wf = distance_phase_split(tconfig.fsvs, scaled[None], tconfig.num_bins)
    np.testing.assert_array_equal(uh, wh[None])
    np.testing.assert_array_equal(ul, wl[None])
    np.testing.assert_array_equal(df, wf[None])
    # switching back to spherical clears the raw coords (planner semantics)
    sp.set_position(azi=270.0, ele=0.0, r=0.51)
    assert sp._coords is None


def test_cartesian_stream_matches_oracle(tdb, tconfig, castanets):
    """A live cartesian-controlled stream matches the port's oracle driven
    through update_from_cartesian on the same xyz sequence."""
    path = [spherical_to_control_xyz(a, 5.0, 0.9) for a in
            (270.0, 270.0, 300.0, 330.0, 0.0, 30.0, 30.0, 60.0)]
    sp = _spat(tdb, tconfig)
    sp.buf = castanets
    orc = OracleSpatializer(tdb, tconfig)
    orc.buf = castanets
    got, want = [], []
    for xyz in path:
        sp.set_position_cartesian(xyz)
        got.append(sp.process_next())
        orc.update_from_cartesian(np.asarray(xyz, np.float32))
        orc.feed_from_buf()
        out = orc.process()
        orc.overlap_save()
        want.append(out)
    rep = precision_check(np.concatenate(got), np.concatenate(want), eps=EPS)
    assert rep.ok, str(rep)


def test_next_block_returns_copies(tdb, tconfig):
    """The playhead must not hand out live views of the buffer."""
    sp = _spat(tdb, tconfig)
    sp.buf = np.arange(4 * tconfig.frames_per_buffer, dtype=np.float32)
    ref = sp.buf.copy()
    blk = sp.next_block()
    blk[:] = -1.0  # caller mutates the returned block
    np.testing.assert_array_equal(sp.buf, ref)  # buffer untouched
    with pytest.raises(ValueError, match="buf"):
        _spat(tdb, tconfig).next_block()


def test_block_shape_and_empty_buffer_guards(tdb, tconfig):
    """A mis-shaped block is a caller bug (loud error, not a silent pad),
    and pulling from an EMPTY playback buffer must not enter the % length
    arithmetic (ZeroDivision)."""
    spat = _spat(tdb, tconfig)
    spat.prime()
    with pytest.raises(ValueError, match="block must be"):
        spat.process_block(np.zeros(tconfig.frames_per_buffer + 1, np.float32))
    spat.buf = np.zeros(0, np.float32)
    with pytest.raises(ValueError, match="playback buffer is empty"):
        spat.next_block()


def test_prime_leaves_the_state_alone(tdb, tconfig, castanets):
    a, b = _spat(tdb, tconfig), _spat(tdb, tconfig)
    for sp in (a, b):
        sp.buf = castanets
        sp.set_position(azi=75, ele=-20, r=0.6)
    a.prime()
    assert a.count == 0 and a.crossfades == 0 and not bool(a._hist.any())
    for _ in range(3):
        np.testing.assert_array_equal(a.process_next(), b.process_next())


def test_entry_points_run_on_the_card_unless_asked(tdb, tconfig, monkeypatch):
    """Every entry point's device defaults to the card; without one it
    raises instead of running on the CPU, and on a card the streaming forms
    take fpb 64 and 16 and refuse, before any launch, a geometry past the
    grid's y (launch B's t-tiles), naming that resource."""
    for fn in (StreamingSpatializer.__init__, render_scan, Renderer.__init__,
               BatchRenderer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sig, pos = np.zeros(512, np.float32), [(0.0, 0.0, 1.0)] * 4
    for make in (lambda: StreamingSpatializer(tdb, tconfig),
                 lambda: render_scan(sig, tdb, pos, tconfig),
                 lambda: Renderer(tdb), lambda: BatchRenderer(tdb)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cfg64 = EngineConfig(frames_per_buffer=64, hrtf_len=192)
    assert cfg64.history_len % 64 == 0 and cfg64.pad_len != 1024
    assert tstream._stream_device("cuda", cfg64) == torch.device("cuda", 0)
    cfg16 = EngineConfig(frames_per_buffer=16, hrtf_len=192)
    assert tstream._stream_device("cuda", cfg16) == torch.device("cuda", 0)
    big = EngineConfig(frames_per_buffer=1 << 24, hrtf_len=192)
    before = dict(tfs.launches)
    match = "t-tiles of 128 columns exceed the 65535 CTAs a grid's y holds"
    with pytest.raises(ValueError, match=match):
        StreamingSpatializer(tdb, big, device="cuda")
    with pytest.raises(ValueError, match=match):
        render_scan(sig, tdb, pos, big, device="cuda")
    assert tfs.launches == before


@pytest.mark.parametrize("fpb,taps", [(96, 256), (100, 512), (441, 512)])
def test_streaming_refuses_a_history_of_partial_blocks(fpb, taps):
    """No longer refused: at a history that is not whole blocks the
    streaming forms take the JAX block step's forward of each window, then
    row 8's apply-only entry (its twin here).  ``StreamingSpatializer``
    moving and held, at pipeline latency 0 and 1, and ``render_scan`` in
    chunks match the JAX package's at 1e-6."""
    from jefferson_tpu import EngineConfig as JaxConfig
    from jefferson_tpu import synthetic_database

    cfg = JaxConfig(frames_per_buffer=fpb, hrtf_len=taps)
    assert cfg.history_len % fpb
    db = synthetic_database(cfg, n_taps=taps, seed=9)
    tdb = database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(cfg))
    sig = (np.random.default_rng(1).standard_normal(20 * fpb) * 0.2).astype(np.float32)
    for latency in (0, 1):
        port = StreamingSpatializer(tdb, pipeline_latency=latency, device="cpu")
        jax = jstream.StreamingSpatializer(db, cfg, pipeline_latency=latency)
        port.buf = jax.buf = sig
        before = dict(tfs.launches)
        for b in range(16):
            if b % 5 == 0:
                for sp in (port, jax):
                    sp.set_position(azi=70.0 * b, ele=-10.0 + b, r=0.4 + 0.1 * b)
            assert np.abs(port.process_next() - jax.process_next()).max() <= EPS
        assert tfs.launches == before  # CPU operands: the twins
        assert port.crossfades == jax.crossfades == 4
    pos = CircularOrbit(period_s=0.2, ele=3, r=1.1).sample(20, cfg)
    got = render_scan(sig, tdb, pos, tdb.config, device="cpu", chunk_blocks=6)
    assert np.abs(got - np.asarray(jstream.render_scan(sig, db, pos, cfg))).max() <= EPS
