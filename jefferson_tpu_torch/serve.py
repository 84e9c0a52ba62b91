"""jefferson-torch-serve — the long-lived render daemon on the card.
Counterpart of ``jefferson_tpu/serve.py``, with the same protocol.

Serving wants a resident engine: the HRTF database loaded, the filter
table on the card and every kernel built once per process, not once per
request.  At start the service builds the CUDA libraries its paths launch
(``kernels.build.build_all``, one nvcc per source at once) and the host
library, uploads the tables and primes one live step, so the first request
pays no compile.  A JSON-line protocol over a Unix domain socket:

    request : {"cmd": "render", "id": 1, "input": "in.wav",
               "output": "out.wav", "trajectory": "orbit:period=4",
               "blocks": 344, "type": 0, "bits": 24}
    response: {"id": 1, "ok": true, "blocks": 344, "seconds": 0.41,
               "rtf": 2.4, "output": "out.wav"}

Other commands: {"cmd": "ping"} / {"cmd": "stats"} (the counters, and the
kernels' launches by name) / {"cmd": "shutdown"}.

Live streaming with interactive source control (the reference's GLUT loop
as a wire protocol: a client moves the source while the audio thread
follows, reference: Jefferson/src/graphics.cu:376-601):

    {"cmd": "stream_start", "input": "in.wav", "output": "live.wav",
     "seconds": 10, "paced": true}                     # -> {"session": "s0"}
    {"cmd": "move", "azi": 90, "ele": 10, "r": 1.0}    # or {"key": "w"}
    {"cmd": "move", "x": 0.5, "y": 0.0, "z": -0.5}     # Cartesian form
    {"cmd": "stream_stop"}                              # -> deadline stats

Several sessions run at once, each with its own spatializer, control
state, output WAV and, on the card, CUDA stream: a session's per-block
synchronize waits for its own block only, never behind a render's queued
chunks.  ``move``/``stream_stop`` take an optional "session" id, which may
be omitted while exactly one session is active.  {"cmd": "stream_list"}
enumerates sessions, and {"cmd": "stream_status"} polls one session's
live position and progress (``viz.live`` draws it).

    python -m jefferson_tpu_torch.serve --socket /tmp/jefferson.sock &
    python -m jefferson_tpu_torch.serve --socket /tmp/jefferson.sock \\
        --request '{"cmd": "render", "input": ...}'

The daemon runs on the card unless started with ``--device cpu`` (the
kernels' plain twins); without a card the default raises.

``--devices N`` serves on a mesh of N ranks, as the JAX daemon serves on a
mesh of N chips: the command re-executes itself as N ranks
(``parallel.mesh.ensure_world``; NCCL on the card, a card a rank, unless
``--backend gloo`` lets the ranks share cards; gloo on the CPU).  Every
rank builds the same service; rank 0 serves the socket and hands each
engine command (``render``, ``scene``) to the others over a broadcast, and
every rank runs it: a render's blocks sharded over a ``blk`` mesh
(``Renderer(mesh=)``, which turns the fused arms off, as in the JAX
package), a scene's sources over a ``src`` mesh (``render_scene_spec``,
shrunk to a count that divides them).  Each request runs in two steps with
the ranks' outcomes gathered after each: the inputs are read (no
collective), then rendered, so a rank that cannot read them makes rank 0's
error reply and leaves no rank waiting in a collective.  Rank 0 writes the
WAV and replies; the reply also carries each rank's record (wall,
collectives, launches: ``parallel.record``).  ``ping``, ``stats`` and the
live sessions stay on rank 0.  ``shutdown`` ends every rank with 0.  The reference
has no serving story (a GLUT window is its interface); this is the
deployment analogue of its always-resident realtime process (reference:
Jefferson/src/main.cu:93-99 keeps the engine alive for the whole session).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import socket
import socketserver
import sys
import threading
import time
from pathlib import Path

import numpy as np

# the CUDA libraries the daemon's paths launch: rows 1-4 and 8 (and launch
# A), rows 5-7, and row 12 under rows 5-7's pre-blend; the first two are
# built for the database's geometry at start
LIBRARIES = ("fused_step_onehot", "fused_step_gather", "dma_blend")

# the engine commands every rank of a mesh runs; the others stay on rank 0
RANKED = ("render", "scene")

# how long a rank of a mesh waits for rank 0's next request: the daemon
# idles between requests, so its command channel (a process group of its
# own) waits far longer than a render's collectives (parallel.mesh.PG_TIMEOUT_S)
CHANNEL_TIMEOUT_S = 365 * 24 * 3600.0


def check_devices(chunk_blocks: int, devices: int | None) -> None:
    """The JAX daemon's check: a render's chunk splits evenly over the mesh."""
    if devices and devices > 1 and chunk_blocks % devices:
        raise ValueError(f"chunk_blocks ({chunk_blocks}) must divide evenly over "
                         f"devices ({devices})")


class RenderService:
    """Resident engine: one Renderer, the scene BatchRenderers per chunk
    size, one HRTF database, every kernel built."""

    def __init__(self, hrtf_dir=None, chunk_blocks: int = 2048, quiet: bool = True,
                 devices: int | None = None, *, device="cuda"):
        """``devices`` above 1: a mesh of that many ranks behind the daemon.
        Every rank of a world of at least ``devices`` ranks builds the
        service (``main`` starts them); outside such a world it raises
        ``make_mesh``'s "requested n devices, have m"."""
        from .cli.main import load_hrtf
        from .config import DEFAULT_CONFIG
        from .engine.renderer import Renderer, resolve_device
        from .parallel import mesh as pm

        check_devices(chunk_blocks, devices)
        self.device = resolve_device(device)
        self.config = DEFAULT_CONFIG
        self.devices = devices
        self.mesh = self._channel = None
        if devices is not None and devices > 1:
            import datetime

            import torch.distributed as dist

            self.mesh = pm.make_mesh(devices, ("blk",), device=self.device)
            # every rank of the world takes every request (ranks past the
            # mesh meet the others in the scenes' mesh set-up), on a channel
            # that waits out the daemon's idle time
            self._channel = dist.new_group(
                backend="gloo", timeout=datetime.timedelta(seconds=CHANNEL_TIMEOUT_S))
        self.rank, self.world = self._rank_and_world()
        self.db = load_hrtf(hrtf_dir, self.config, quiet=quiet)
        self.renderer = Renderer(self.db, self.config, device=self.device,
                                 chunk_blocks=chunk_blocks, mesh=self.mesh)
        self._warm()
        # scene BatchRenderers persist across requests (each holds its
        # table on the card), keyed by (chunk, device) in render_scene_spec
        self._scene_renderers: dict = {}
        self.stats = {"renders": 0, "blocks": 0, "seconds": 0.0, "errors": 0}
        # the threading server handles clients concurrently, but renders
        # share one Renderer and one card: serialize engine commands
        # (render/scene) under _lock.  Stream sessions have their own
        # spatializers and must NOT block behind a render (or each other):
        # _slock guards only _streams bookkeeping; the heavy parts of
        # stream_start (WAV read/resample) and stream_stop (joining a
        # session thread) run OUTSIDE both locks.
        self._lock = threading.Lock()
        self._slock = threading.Lock()
        # live sessions take turns a block at a time: session threads that
        # run their blocks at once hand the interpreter lock back and forth
        # inside every block, and four sessions then take several times one
        # session's block time each (PERF.md, PR 12)
        self._live = threading.Lock()
        # paced sessions' block clocks start on a grid of the block period
        # from here, each at its own offset (phase), so that sessions started
        # together do not all wake at once every block and wait in turn
        self._epoch = time.perf_counter()
        # _streams is COPY-ON-WRITE: every mutation rebuilds the dict under
        # _slock and reassigns the attribute; readers (move/stream_list)
        # take one snapshot reference and never see a half-mutated dict.
        self._streams: dict[str, dict] = {}
        self._stream_seq = 0
        self.max_streams = 8
        # ended-but-unstopped sessions stay in _streams so a later
        # stream_stop can still collect their deadline stats (another
        # client's stream_start must not evict them); they hold the
        # playback buffer, so the oldest ended are pruned past this cap
        self.max_ended_retained = 8
        # per-session join window at shutdown (a session still alive past
        # it is reported as pending, never claimed stopped)
        self.shutdown_join_s = 10.0
        # set under _slock by shutdown; a registration (also under _slock)
        # rejects once it is up, so no session slips in between shutdown's
        # snapshot and its join pass
        self._shutting_down = False

    def _warm(self) -> None:
        """Build every library the daemon launches, upload the live path's
        shared table and flags, prime one live step and render a few blocks,
        so no request pays a compile, a first upload, a kernel's first load
        or the render path's imports."""
        from . import native
        from .cli.main import parse_trajectory
        from .engine.stream import StreamingSpatializer
        from .io import resample  # noqa: F401  (scipy.signal: a second on a first import)

        from .parallel.mesh import in_mesh

        native.library()
        if self.device.type == "cuda":
            from .kernels import build

            build.build_all(LIBRARIES, geometries=[(self.config.frames_per_buffer,
                                                     self.config.pad_len)])
        if self.rank == 0:  # the live sessions run on rank 0 alone
            StreamingSpatializer(self.db, self.config, device=self.device).prime()
        fpb = self.config.frames_per_buffer
        if in_mesh(self.mesh):  # every rank of a mesh, together
            self.renderer.render(np.zeros(8 * fpb, np.float32),
                                 parse_trajectory("orbit:period=0.05").sample(8, self.config))

    def _rank_and_world(self) -> tuple[int, int]:
        """This process's rank and the world's size: (0, 1) without a mesh."""
        if self.mesh is None:
            return 0, 1
        import torch.distributed as dist

        return dist.get_rank(), dist.get_world_size()

    def handle(self, req: dict) -> dict:
        cmd = req.get("cmd", "render")
        rid = req.get("id")
        if not isinstance(cmd, str):
            # an unhashable cmd ([1], {...}) would raise in the dispatch
            # below: a dropped connection instead of an error reply
            return {"id": rid, "ok": False,
                    "error": f"cmd must be a string, got {type(cmd).__name__}"}
        if cmd == "ping":
            return {"id": rid, "ok": True, "pong": True}
        if cmd == "stats":
            from .kernels import fused_step

            # the kernels' launch counts since the process started, launch A
            # as "forward_distance" (a launch in one thread may race an
            # increment in another)
            from .parallel.mesh import collectives

            launched = {k: v for k, v in fused_step.launches.items() if v}
            if n := sum(fused_step.forward_launches.values()):
                launched["forward_distance"] = n
            # rank 0's counts: its launches and the collectives it met
            return {"id": rid, "ok": True, **self.stats, "launches": launched,
                    "world": self.world, "collectives": dict(collectives)}
        if cmd == "shutdown":
            # stop live sessions first so their writers flush
            stopped, pending = [], []
            # on a mesh, between engine commands: the other ranks leave, once
            engine = self._lock if self._channel is not None else contextlib.nullcontext()
            with engine:
                if self._channel is not None and not self._shutting_down:
                    self._broadcast({"cmd": "shutdown"})
                with self._slock:
                    # one snapshot + flag under the lock: a racing registration
                    # either lands before the snapshot (and is quit + joined
                    # below) or sees the flag and is rejected
                    self._shutting_down = True
                    snapshot = self._streams
            for s in snapshot.values():
                s["control"].quit = True
            for sid, s in snapshot.items():
                s["thread"].join(timeout=self.shutdown_join_s)
                # a join that timed out is not claimed as stopped: its
                # writer has not flushed
                (pending if s["thread"].is_alive() else stopped).append(sid)
            with self._slock:
                # timed-out sessions stay visible; each closes its own
                # writer in its run() finally if it finishes before exit
                self._streams = {sid: snapshot[sid] for sid in pending}
            resp = {"id": rid, "ok": True, "shutdown": True, "stopped_sessions": stopped}
            if pending:
                resp["pending_sessions"] = pending
                resp["warning"] = (
                    f"sessions did not stop within {self.shutdown_join_s:g} s; their "
                    "output WAVs may be unflushed if the process exits before they do"
                )
            return resp
        if cmd in ("move", "stream_status"):
            # lock-free: one copy-on-write snapshot of _streams, then only
            # the stream's own control/playout state is touched
            try:
                fn = self._move if cmd == "move" else self._stream_status
                return {"id": rid, **fn(req)}
            except Exception as e:
                return {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"}
        if cmd == "stream_list":
            streams = self._streams  # copy-on-write snapshot
            return {"id": rid, "ok": True, "sessions": {
                k: {"output": v["output"], "blocks": v["play"].stats.blocks,
                    "alive": v["thread"].is_alive()}
                for k, v in streams.items()
            }}
        if cmd in ("stream_start", "stream_stop"):
            # own locking discipline (see __init__): must not serialize
            # behind a render or hold the engine lock across a join
            try:
                fn = self._stream_start if cmd == "stream_start" else self._stream_stop
                return {"id": rid, **fn(req)}
            except Exception as e:
                self.stats["errors"] += 1
                return {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"}
        if cmd not in RANKED:
            return {"id": rid, "ok": False, "error": f"unknown cmd {cmd!r}"}
        with self._lock:
            if self._channel is not None:
                if self._shutting_down:  # the other ranks have left
                    return {"id": rid, "ok": False, "error": "daemon is shutting down"}
                self._broadcast(req)
            return {"id": rid, **self.run(req)}

    # --- engine commands, on every rank of a mesh --------------------------

    def run(self, req: dict) -> dict:
        """One engine command on this rank: its inputs read, then rendered
        (and written, on rank 0) -> the reply, rank 0's (the others' is
        empty).  On a mesh the ranks' outcomes are gathered after each step:
        a failure on any rank skips what follows on every rank and becomes
        the error reply, with each rank's record."""
        from .parallel import record

        records, job = [], None
        # on a mesh the ranks' walls hold their device time
        sync = self.device if self.world > 1 else None
        try:
            for step, fn in (("read its inputs", lambda: self._prepare(req)),
                             ("render", lambda: self._finish(job))):
                try:
                    out, rec = record.recorded(fn, sync)
                    err = None
                except Exception as e:
                    rec, err = None, e
                self._gather(rec, err, records, step)
                if job is None:
                    job = out
        except Exception as e:  # report, don't kill the daemon
            self.stats["errors"] += 1
            error = str(e) if isinstance(e, _RankFailed) else f"{type(e).__name__}: {e}"
            return {"ok": False, "error": error, **({"ranks": records} if records else {})}
        return {**job["reply"], **({"ranks": records} if records else {})}

    def _broadcast(self, req: dict) -> None:
        """Rank 0 hands ``req`` to every rank (``follow``)."""
        import torch.distributed as dist

        dist.broadcast_object_list([req], src=0, group=self._channel)

    def _gather(self, rec, err, records: list, step: str):
        """Every rank's outcome of ``step`` (its record, or its error) on
        every rank; raise _RankFailed naming the failed ranks, else True.
        Without a mesh only this rank's: a local error is re-raised."""
        if self._channel is None:
            if err is not None:
                raise err
            return True
        mine = {**(rec or {"rank": self.rank}),
                "error": None if err is None else f"{type(err).__name__}: {err}"}
        import torch.distributed as dist

        every = [None] * self.world
        dist.all_gather_object(every, mine, group=self._channel)
        records.append({"step": step, "ranks": every})
        failed = [r for r in every if r["error"] is not None]
        if failed:
            raise _RankFailed("; ".join(f"rank {r['rank']} could not {step}: {r['error']}"
                                        for r in failed))
        return True

    def _write(self, req: dict, out: np.ndarray, what: str) -> None:
        from .io.wavio import resolve_float_bits, write_wav

        if not np.isfinite(out).all():
            raise ValueError(f"non-finite samples in {what} output")
        ffmt = bool(req.get("float", False))
        write_wav(req["output"], out, self.config.sample_rate,
                  bits=resolve_float_bits(int(req.get("bits", 24)), ffmt), float_format=ffmt)

    def _prepare(self, req: dict) -> dict:
        """An engine command's inputs, read with no collective -> its job."""
        cmd = req.get("cmd", "render")
        return (self._render_inputs if cmd == "render" else self._scene_inputs)(req)

    def _finish(self, job: dict) -> bool:
        """Render a prepared job (the collectives of a mesh inside), write its
        WAV on rank 0 and fill in its reply."""
        t0 = time.time()
        out, nb = job["render"]()
        dt = time.time() - t0
        job["reply"] = {}
        if self.rank == 0:
            self._write(job["req"], out, job["what"])
            self.stats["renders"] += 1
            self.stats["blocks"] += nb
            self.stats["seconds"] += dt
            job["reply"] = job["reply_of"](nb, dt)
        return True

    def _render_inputs(self, req: dict) -> dict:
        from .cli.main import parse_trajectory
        from .config import ProcessType
        from .io.resample import read_wav_mono_at
        from .parallel.mesh import in_mesh

        cfg = self.config
        signal = read_wav_mono_at(req["input"], cfg.sample_rate)
        if len(signal) == 0:
            raise ValueError(f"input WAV {req['input']!r} is empty")
        traj = parse_trajectory(req.get("trajectory", "static:azi=0,ele=0,r=0.5"))
        # explicit-but-invalid fields error, never read as absent
        if req.get("blocks") is not None:
            nb = int(req["blocks"])
            if nb < 1:
                raise ValueError(f"blocks ({nb}) must be positive")
        elif req.get("duration") is not None:
            dur = float(req["duration"])
            if not dur > 0:
                raise ValueError(f"duration ({dur}) must be positive")
            nb = int(np.ceil(dur / cfg.block_duration))
        else:
            nb = int(np.ceil(len(signal) / cfg.frames_per_buffer))
        positions = traj.sample(nb, cfg)
        ptype = ProcessType(int(req.get("type", 0)))

        def render():
            # a rank of a larger world than the mesh renders nothing
            out = (self.renderer.render(signal, positions, ptype) if in_mesh(self.mesh)
                   else None)
            return out, nb

        def reply(nb, dt):
            audio_s = nb * cfg.block_duration
            return {
                "ok": True,
                "output": req["output"],
                "blocks": nb,
                "seconds": round(dt, 4),
                "rtf": round(audio_s / dt, 2) if dt > 0 else None,
            }

        return {"req": req, "what": "render", "render": render, "reply_of": reply}

    # --- live stream session (interactive source control) -----------------

    def _stream_start(self, req: dict) -> dict:
        """Start a background block loop whose source position is
        commandable mid-stream: the reference's graphics/audio thread split
        (graphics writes coordinates, audio reads: graphics.cu:376-386) as
        a daemon protocol.  On the card the session runs on a CUDA stream
        of its own."""
        import torch

        from .engine.stream import StreamingSpatializer
        from .io.resample import read_wav_mono_at
        from .io.wavio import StreamingWavWriter
        from .rt.control import SourceControl
        from .rt.playout import AudioPlayout

        # cheap pre-check (the authoritative one is under _slock at
        # registration); the heavy prep below runs unlocked.  Capacity
        # counts LIVE sessions only.
        streams_snap = self._streams  # copy-on-write snapshot
        if sum(1 for v in streams_snap.values()
               if v["thread"].is_alive()) >= self.max_streams:
            return {"ok": False,
                    "error": f"too many active stream sessions ({self.max_streams})"}
        cfg = self.config
        # request-field validation BEFORE the WAV read
        seconds = float(req.get("seconds", 10.0))
        if seconds <= 0:
            return {"ok": False, "error": f"seconds must be > 0, got {seconds}"}
        if "blocks" in req:
            return {"ok": False, "error": "stream_start takes 'seconds', not 'blocks'"}
        signal = read_wav_mono_at(req["input"], cfg.sample_rate)
        if len(signal) == 0:
            # the wrapping playhead raises on an empty buffer
            return {"ok": False, "error": f"input WAV {req['input']!r} is empty"}
        num_blocks = int(np.ceil(seconds / cfg.block_duration))
        # the session's own stream: its spatializer's buffers are made on it
        # and its loop runs on it (torch.cuda.stream(None) is a no-op)
        own = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        with torch.cuda.stream(own):
            spat = StreamingSpatializer(self.db, cfg, device=self.device)
        spat.buf = signal  # wrapping playhead lives in the spatializer
        control = SourceControl()
        last = [None]  # the coordinates the spatializer was last moved to

        def source():
            with self._live:
                xyz = control.coordinates()
                if xyz != last[0]:  # most blocks hold: skip the conversion
                    spat.set_position_cartesian(xyz)
                    last[0] = xyz
                return spat.process_next()

        writer = StreamingWavWriter(req["output"], cfg.sample_rate)
        play = AudioPlayout([source], cfg, writer=writer)
        paced = bool(req.get("paced", True))
        seq = [0]  # the session's number, set at registration

        def run():
            try:
                with torch.cuda.stream(own):
                    spat.prime()  # the build and first upload before the clock starts
                    if paced:
                        time.sleep(self._phase_delay(seq[0]))
                    play.run_offline(num_blocks, paced=paced, stop=lambda: control.quit)
            finally:
                writer.close()

        t = threading.Thread(target=run, daemon=True)
        with self._slock:
            if self._shutting_down:
                writer.close()
                return {"ok": False, "error": "daemon is shutting down"}
            streams = dict(self._streams)
            if sum(1 for v in streams.values()
                   if v["thread"].is_alive()) >= self.max_streams:
                writer.close()
                return {"ok": False,
                        "error": f"too many active stream sessions ({self.max_streams})"}
            # keep ended sessions queryable (their stream_stop stats), but
            # prune the OLDEST ended beyond the cap (insertion order = start order)
            ended = [k for k, v in streams.items() if not v["thread"].is_alive()]
            for k in ended[: max(0, len(ended) - self.max_ended_retained)]:
                del streams[k]
            sid, seq[0] = f"s{self._stream_seq}", self._stream_seq
            self._stream_seq += 1
            streams[sid] = {
                "thread": t, "control": control, "play": play, "spat": spat,
                "output": req["output"], "blocks": num_blocks,
            }
            self._streams = streams
            # start INSIDE the registration lock: every thread visible in
            # _streams has started, so shutdown's join never meets an
            # unstarted thread (only joins are kept out of the locks)
            t.start()
        return {"ok": True, "session": sid, "output": req["output"],
                "blocks": num_blocks, "paced": paced}

    def _phase_delay(self, seq: int) -> float:
        """Seconds until session ``seq``'s clock should start: the next
        time on the block grid plus its phase, 0, 1/2, 1/4, 3/4, 1/8, ... of
        a block by start order (3-bit reversal), so two, four or eight
        sessions spread their blocks evenly over the period."""
        period = self.config.block_duration
        phase = int(f"{seq % 8:03b}"[::-1], 2) / 8 * period
        return (self._epoch + phase - time.perf_counter()) % period

    def _session(self, req: dict):
        """Resolve a stream session from the optional 'session' field;
        returns (session dict | None, error dict | None).  Reads one
        copy-on-write snapshot of _streams."""
        streams = self._streams
        sid = req.get("session")
        if sid is not None:
            s = streams.get(sid)
            return (s, None) if s is not None else (
                None, {"ok": False, "error": f"no stream session {sid!r}"})
        if not streams:
            return None, {"ok": False, "error": "no active stream session"}
        if len(streams) > 1:
            return None, {"ok": False,
                          "error": "multiple sessions active; pass 'session' "
                                   f"(one of {sorted(streams)})"}
        return next(iter(streams.values())), None

    @staticmethod
    def _ended(s: dict) -> bool:
        """True when the session's block loop has run and finished (a
        thread not yet started is not ended)."""
        t = s["thread"]
        return t.ident is not None and not t.is_alive()

    def _move(self, req: dict) -> dict:
        """Move the live source (spherical, Cartesian, or a reference key)."""
        from .rt.control import spherical_to_control_xyz
        from .trajectory.spatial import cartesian_to_spherical

        s, err = self._session(req)
        if err is not None:
            return err
        if self._ended(s):
            # a move after the session's end must not report ok
            return {"ok": False, "error": "stream session has ended"}
        known = {"azi", "ele", "r", "x", "y", "z", "key"}
        given = {k for k in req if k not in ("cmd", "id", "session")}
        if not given & known:
            # a typo'd field must not snap the position while reporting ok
            return {"ok": False,
                    "error": f"move needs one of {sorted(known)}; got {sorted(given)}"}
        control = s["control"]
        if "key" in req:
            control.apply_key(str(req["key"]))
        elif "x" in req or "y" in req or "z" in req:
            x0, y0, z0 = control.coordinates()
            control.move_to(req.get("x", x0), req.get("y", y0), req.get("z", z0))
        else:
            a, e, r = cartesian_to_spherical(np.asarray(control.coordinates()))
            xyz = spherical_to_control_xyz(
                float(req.get("azi", a)), float(req.get("ele", e)), float(req.get("r", r))
            )
            control.move_to(*xyz)
        a, e, r = cartesian_to_spherical(np.asarray(control.coordinates()))
        return {"ok": True, "azi": float(a), "ele": float(e), "r": float(r),
                "quit": control.quit}

    def _stream_status(self, req: dict) -> dict:
        """Current position + playout progress of one live session: the
        poll behind live in-play visualization (the reference redraws
        listener + source at ~100 Hz while audio plays,
        Jefferson/src/graphics.cu:352-453).  Lock-free snapshot."""
        from .trajectory.spatial import cartesian_to_spherical

        s, err = self._session(req)
        if err is not None:
            return err
        x, y, z = s["control"].coordinates()
        a, e, r = cartesian_to_spherical(np.asarray((x, y, z)))
        stats = s["play"].stats
        return {
            "ok": True, "output": s["output"],
            "x": float(x), "y": float(y), "z": float(z),
            "azi": float(a), "ele": float(e), "r": float(r),
            "blocks": stats.blocks, "total_blocks": s["blocks"],
            "alive": s["thread"].is_alive(), "clipping": s["play"].clipping,
        }

    def _stream_stop(self, req: dict) -> dict:
        """Stop a session and return its deadline stats: the JAX reply's
        fields, plus the block times' median, p90 and p99 (the live gate's
        numbers)."""
        s, err = self._session(req)
        if err is not None:
            return err
        # quit + join with NO lock held
        s["control"].quit = True
        s["thread"].join(timeout=30.0)
        if s["thread"].is_alive():
            return {"ok": False, "error": "stream did not stop in 30 s"}
        with self._slock:
            self._streams = {k: v for k, v in self._streams.items() if v is not s}
        stats = s["play"].stats
        pct = (np.percentile(stats.compute_ms, [50, 90, 99]) if stats.compute_ms
               else np.zeros(3))
        return {
            "ok": True,
            "output": s["output"],
            "blocks": stats.blocks,
            "avg_ms": round(stats.avg_ms, 3),
            "max_ms": round(stats.max_ms, 3),
            "median_ms": round(float(pct[0]), 3),
            "p90_ms": round(float(pct[1]), 3),
            "p99_ms": round(float(pct[2]), 3),
            "budget_ms": round(stats.budget_ms, 3),
            "misses": stats.misses,
            "clipping": s["play"].clipping,
            "crossfades": s["spat"].crossfades,
        }

    def _scene_inputs(self, req: dict) -> dict:
        """Multi-source scene mix: {"cmd": "scene", "scene": {...} | path}."""
        from .cli.main import render_scene_inputs, scene_inputs

        scene = req["scene"]
        if isinstance(scene, str):
            scene = json.loads(Path(scene).read_text())
        chunk = None if req.get("chunk_blocks") is None else int(req["chunk_blocks"])
        inputs = scene_inputs(scene, self.config, num_blocks=req.get("blocks"),
                              duration=req.get("duration"), chunk_blocks=chunk)

        def render():
            return render_scene_inputs(inputs, self.db, self.config, chunk_blocks=chunk,
                                       devices=self.devices,
                                       renderer_cache=self._scene_renderers, device=self.device)

        def reply(nb, dt):
            return {"ok": True, "output": req["output"], "blocks": nb,
                    "sources": len(scene.get("sources", [])), "seconds": round(dt, 4)}

        return {"req": req, "what": "scene", "render": render, "reply_of": reply}


class _RankFailed(RuntimeError):
    """A step of an engine command failed on some rank of the mesh."""


def follow(service: RenderService) -> None:
    """A rank past 0 of a meshed daemon: run every engine command rank 0
    broadcasts, until its shutdown."""
    import torch.distributed as dist

    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=service._channel)
        req = box[0]
        if req.get("cmd") == "shutdown":
            return
        service.run(req)


def serve(socket_path: str | Path, service: RenderService) -> None:
    """Blocking JSON-line server over a Unix domain socket."""
    socket_path = Path(socket_path)
    socket_path.unlink(missing_ok=True)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": f"bad json: {e}"}
                else:
                    if isinstance(req, dict):
                        resp = service.handle(req)
                    else:  # valid JSON but not an object ([1], "x", null...)
                        resp = {"ok": False,
                                "error": f"request must be a JSON object, "
                                         f"got {type(req).__name__}"}
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                if resp.get("shutdown"):
                    # shut down from another thread so this handler can finish
                    threading.Thread(target=self.server.shutdown, daemon=True).start()
                    return

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True
        allow_reuse_address = True
        # server_close() must not join handler threads: a client holding an
        # idle connection would hang shutdown (Python 3.10/3.11 join them
        # unless block_on_close is False; 3.12 skips daemon threads)
        block_on_close = False

    with Server(str(socket_path), Handler) as srv:
        srv.serve_forever()
    socket_path.unlink(missing_ok=True)


def request(socket_path: str | Path, req: dict, timeout: float = 600.0) -> dict:
    """Send one request to a running daemon and return its response."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(str(socket_path))
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jefferson-torch-serve",
                                description=__doc__.splitlines()[0])
    p.add_argument("--socket", default="/tmp/jefferson.sock")
    p.add_argument("--hrtf-dir", default=None)
    p.add_argument("--chunk-blocks", type=int, default=2048)
    p.add_argument("--devices", type=int, default=None,
                   help="serve on a mesh of N ranks (the command re-executes itself as N "
                        "ranks): renders sharded over their blocks, scenes over their "
                        "sources; rank 0 serves the socket")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="the mesh's torch.distributed backend (default: NCCL on the card, a "
                        "card a rank; gloo on the CPU; gloo lets ranks share a card)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the card (the default; raises without one); cpu = the "
                        "kernels' plain twins")
    p.add_argument("--request", default=None,
                   help="client mode: send this JSON request to a running daemon")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="client-mode response timeout, s")
    args = p.parse_args(argv)
    if args.chunk_blocks < 1:
        raise SystemExit(f"--chunk-blocks {args.chunk_blocks} must be a positive block count")

    if args.request is not None:
        resp = request(args.socket, json.loads(args.request), timeout=args.timeout)
        print(json.dumps(resp))
        return 0 if resp.get("ok") else 1

    if args.devices is not None and args.devices < 1:
        raise SystemExit(f"--devices {args.devices} must be positive")
    device = args.device
    try:
        check_devices(args.chunk_blocks, args.devices)  # before any rank starts
        if args.devices and args.devices > 1:
            from .parallel.mesh import ensure_world

            device = ensure_world(args.devices, device=args.device, backend=args.backend)
        service = RenderService(args.hrtf_dir, chunk_blocks=args.chunk_blocks,
                                devices=args.devices, device=device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"jefferson-torch-serve: {e}")
    if service.rank == 0:
        print(f"jefferson-torch-serve: listening on {args.socket} ({service.device}"
              + (f", {service.world} ranks" if service.world > 1 else "") + ")",
              file=sys.stderr)
        serve(args.socket, service)
    else:
        follow(service)
    if service.mesh is not None:  # every rank past the shutdown, then the world ends
        import torch.distributed as dist

        dist.barrier(group=service._channel)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
