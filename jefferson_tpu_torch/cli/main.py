"""jefferson-torch: the offline binaural render CLI on one NVIDIA GPU.

Counterpart of ``jefferson_tpu/cli/main.py`` (``python -m
jefferson_tpu_torch.cli.main``), with the same flags, validations and
messages.  The reference's app surface is ``-t <0-5> -i in.wav -r
reverb.wav -o out.wav`` (reference: Jefferson/src/main.cu:22-58) plus a
GLUT window moving the source; this CLI keeps those flags, renders along a
trajectory instead of the window, and makes the reference's compile-time
switches (reverb on/off, HRTF dir, block count) options.

``--device cuda`` (the default) renders on the card and raises without
one; ``--device cpu`` runs the same dispatch on the kernels' plain twins.
Nothing falls back from one to the other.  ``--devices N`` above 1 renders
on N ranks (``parallel.mesh.ensure_world`` re-executes the command as N
ranks unless it already is one): a scene's sources shard over a ``src``
mesh (shrunk to the largest count that divides them), a single source's
blocks over a ``blk`` mesh; rank 0 writes the output.  On ``cuda`` the N
ranks need N cards (NCCL), and fewer raises.  ``--profile-dir`` traces the whole
file-to-file run, each host stage a named span (``cli.read_wav``,
``cli.reverb``, ``cli.load_hrtf``, ``cli.selftest``, ``cli.render`` with the
renderer's ``renderer.plan`` and ``renderer.chunks``, ``cli.write``,
``cli.viz``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jefferson-torch",
        description="Binaural spatializer on one NVIDIA GPU (file-to-file)",
    )
    from .. import __version__

    p.add_argument("--version", action="version",
                   version=f"jefferson_tpu_torch {__version__}")
    p.add_argument("-t", "--type", type=int, default=0, choices=range(6),
                   help="process type: 0=FD interpolating, 1=FD nearest, 2=time-domain "
                        "(on --device), 3/4/5=CPU oracle equivalents (default 0)")
    p.add_argument("-i", "--input", default=None, help="input WAV (mono or stereo; downmixed)")
    p.add_argument("--scene", default=None,
                   help="multi-source scene JSON: {\"sources\": [{\"input\": WAV, "
                        "\"trajectory\": SPEC, \"gain\": 1.0}, …]} — sources are "
                        "rendered together on the batched renderer and mixed like the "
                        "reference's per-source accumulation (Audio.cu:98-158)")
    p.add_argument("-r", "--reverb", default=None, help="reverb impulse-response WAV (mono)")
    p.add_argument("-o", "--output", default="ofile.wav", help="output WAV (default ofile.wav)")
    p.add_argument("--reverb-backend", choices=["host", "device"], default="host",
                   help="host = one-shot scipy FFT (the default); device = "
                        "partitioned convolution on --device")
    p.add_argument("--reverb-mode", choices=["off", "reference", "linear"], default="off",
                   help="off (reference default reverbFlag=false), reference "
                        "(circular wrap + RMS renorm), or linear convolution")
    p.add_argument("--hrtf-dir", default=None,
                   help="HRTF database: a KEMAR dir (full or compact layout) or "
                        "a SOFA (.sofa) file; default: $JEFFERSON_HRTF_DIR, "
                        "else a deterministic synthetic set")
    p.add_argument("--trajectory", default="static:azi=0,ele=0,r=0.5",
                   help="trajectory spec: static:azi=A,ele=E,r=R | "
                        "orbit:period=P,ele=E,r=R[,start=A] | "
                        "sweep:start=A,step=S,blocks=N,steps=K[,ele=E,r=R] | "
                        "path:x0,y0,z0:x1,y1,z1:duration | events:FILE.json")
    p.add_argument("--blocks", type=int, default=None,
                   help="number of 128-sample blocks (default: one pass of the input)")
    p.add_argument("--duration", type=float, default=None, help="render length in seconds")
    p.add_argument("--bits", type=int, default=24, choices=[16, 24, 32],
                   help="output PCM depth (default 24, the reference's format)")
    p.add_argument("--float", action="store_true", help="write float32 WAV instead of PCM")
    p.add_argument("--backend", choices=["matmul", "fft"], default="matmul",
                   help="matmul = float32 planes and the CUDA steps; fft = complex64 "
                        "through torch.fft (no fused steps)")
    p.add_argument("--pipeline-fetch", action="store_true",
                   help="fetch each chunk's output one chunk late, after the next "
                        "chunk is launched (single-source renders; bit-identical)")
    p.add_argument("--no-fused", action="store_true",
                   help="run the unfused chunks (plain torch) instead of the CUDA steps")
    p.add_argument("--chunk-blocks", type=int, default=None,
                   help="blocks per chunk (default: 2048 single-source; scenes "
                        "auto-size, 256 lowered toward 8192-row steps on hold scenes)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the card (the default; raises without one); cpu = the "
                        "kernels' plain twins on the CPU")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the render over N ranks, one per device: a scene's "
                        "sources, or a single source's blocks (on cuda: N cards)")
    p.add_argument("--initial-old", default="0,0",
                   help="crossfade state before block 0 as 'azi,ele' (reference "
                        "constructor default 0,0) or 'none' to disable")
    p.add_argument("--viz", action="store_true",
                   help="write <output>.scene.svg, <output>.wave.svg, <output>.html and "
                        "<output>.3d.html (the offline analogue of the reference's GL "
                        "window)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the run (host stages as "
                        "named spans, the card's kernels) into this dir")
    p.add_argument("--no-resample", action="store_true",
                   help="feed wrong-rate inputs raw (pitch-shifted) like the reference")
    p.add_argument("--selftest", action="store_true",
                   help="run a SCALED engine-vs-oracle smoke gate before rendering (the "
                        "4 scenarios of the reference's benchmarkTesting, main.cu:88, at "
                        "8 blocks x 12 steps instead of 172 x 72); aborts on mismatch")
    p.add_argument("--selftest-full", action="store_true",
                   help="run the reference's FULL benchmarkTesting workload (4 scenarios "
                        "x 73 positions x 172 blocks) and the mover before rendering; "
                        "python -m jefferson_tpu_torch.bench.sweep runs the scenes too")
    p.add_argument("--quiet", action="store_true")
    return p


def parse_trajectory(spec: str):
    """Trajectory spec string -> Trajectory.

    Raises ValueError on malformed specs, not SystemExit: the parser is
    shared with callers that catch Exception per request (the JAX package's
    render daemon), which a SystemExit would escape.  CLI call sites convert
    to SystemExit themselves."""
    from ..trajectory.trajectory import (
        AzimuthSweep,
        CircularOrbit,
        LinearPath,
        PositionEvents,
        StaticPosition,
    )

    kind, _, rest = spec.partition(":")

    def kv(defaults):
        out = dict(defaults)
        if rest:
            for item in rest.split(","):
                k, _, v = item.partition("=")
                if k not in out:
                    raise ValueError(f"unknown trajectory parameter {k!r} for {kind!r}")
                try:
                    out[k] = float(v)
                except ValueError:
                    raise ValueError(
                        f"trajectory parameter {k!r} for {kind!r} needs a "
                        f"number, got {v!r}"
                    ) from None
        return out

    if kind == "static":
        d = kv({"azi": 0.0, "ele": 0.0, "r": 0.5})
        return StaticPosition(d["azi"], d["ele"], d["r"])
    if kind == "orbit":
        d = kv({"period": 8.0, "ele": 0.0, "r": 1.0, "start": 0.0})
        return CircularOrbit(period_s=d["period"], ele=d["ele"], r=d["r"], start_azi=d["start"])
    if kind == "sweep":
        d = kv({"start": 0.0, "step": 5.0, "blocks": 172, "steps": 72, "ele": 0.0, "r": 0.5})
        return AzimuthSweep(
            start_azi=d["start"], ele=d["ele"], r=d["r"], step_deg=d["step"],
            blocks_per_step=int(d["blocks"]), num_steps=int(d["steps"]),
        )
    if kind == "path":
        parts = rest.split(":")
        if len(parts) != 3:
            raise ValueError("path spec: path:x0,y0,z0:x1,y1,z1:duration")
        try:
            a = tuple(float(v) for v in parts[0].split(","))
            b = tuple(float(v) for v in parts[1].split(","))
            return LinearPath(a, b, float(parts[2]))
        except ValueError:
            raise ValueError(
                f"path spec needs numeric x,y,z:x,y,z:duration, got {rest!r}"
            ) from None
    if kind == "events":
        try:
            events = json.loads(Path(rest).read_text())
        except FileNotFoundError:
            raise ValueError(f"events trajectory file {rest!r} not found") from None
        except json.JSONDecodeError as e:
            raise ValueError(f"events trajectory file {rest!r}: bad JSON: {e}") from None
        return PositionEvents([tuple(e) for e in events])
    raise ValueError(f"unknown trajectory kind {kind!r}")


def load_hrtf(hrtf_dir, config, quiet=False):
    import os

    from ..hrtf.kemar import load_database, synthetic_database

    hrtf_dir = hrtf_dir or os.environ.get("JEFFERSON_HRTF_DIR")
    if hrtf_dir:
        if not Path(hrtf_dir).exists():
            raise SystemExit(
                f"HRTF dir {hrtf_dir!r} does not exist — fetch the MIT KEMAR "
                "set with scripts/fetch_kemar.py or point --hrtf-dir/"
                "$JEFFERSON_HRTF_DIR at an existing full/compact tree"
            )
        return load_database(hrtf_dir, config)
    if not quiet:
        print(
            "warning: no HRTF dir given; using the synthetic test set "
            "(real KEMAR data: scripts/fetch_kemar.py, then --hrtf-dir "
            "or $JEFFERSON_HRTF_DIR)",
            file=sys.stderr,
        )
    return synthetic_database(config)


def scene_devices(num_sources: int, devices: int | None, quiet: bool = True) -> int:
    """The --devices count a scene shards over: the largest count up to
    ``devices`` that divides the sources (the fused steps need even source
    shards; a lopsided mesh would take the unfused arms), with a warning
    when it shrinks."""
    if not devices or devices <= 1:
        return 1
    n = min(devices, num_sources)
    while num_sources % n:
        n -= 1
    if n != devices and not quiet:
        print(f"warning: --devices {devices} shrunk to {n} (must divide the "
              f"{num_sources}-source scene)", file=sys.stderr)
    return n


def scene_mesh(num_sources: int, devices: int | None, quiet: bool = True, *, device="cuda"):
    """The --devices source mesh of a scene (``scene_devices`` ranks), or
    None for one device.  Every rank of the world calls it."""
    n = scene_devices(num_sources, devices, quiet)
    if n <= 1:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(n, ("src",), device=device)


def is_writer() -> bool:
    """Whether this process writes the outputs: rank 0 of a world, or a
    process outside one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


# Bound on a long-lived caller's scene-renderer cache (render_scene_spec):
# each entry keeps a BatchRenderer and its filter table on the device.
_SCENE_RENDERER_CACHE_MAX = 8


def render_scene_spec(
    scene: dict,
    db,
    config,
    num_blocks: int | None = None,
    duration: float | None = None,
    chunk_blocks: int | None = None,
    quiet: bool = True,
    devices: int | None = None,
    renderer_cache: dict | None = None,
    device="cuda",
):
    """Render a scene dict ({"sources": [{"input", "trajectory", "gain"}…]})
    into one stereo mix on ``device``.  ``renderer_cache``: long-lived
    callers pass a dict so BatchRenderers persist across requests, keyed by
    (chunk size, device[, mesh size]), least recently used evicted past
    _SCENE_RENDERER_CACHE_MAX.  ``devices`` above 1 shards the sources over
    a source mesh of that many ranks (``scene_mesh``); every rank of the
    world calls this and every rank of the mesh gets the mix (a rank of a
    larger world outside the mesh renders nothing and gets None).  The
    inputs are read first, with no collective (``scene_inputs``), then
    rendered (``render_scene_inputs``)."""
    inputs = scene_inputs(scene, config, num_blocks, duration, chunk_blocks, quiet)
    return render_scene_inputs(inputs, db, config, chunk_blocks, quiet, devices,
                               renderer_cache, device)


def scene_inputs(scene: dict, config, num_blocks: int | None = None,
                 duration: float | None = None, chunk_blocks: int | None = None,
                 quiet: bool = True) -> tuple[np.ndarray, np.ndarray, int]:
    """A scene's fed streams (S, ...), positions (S, nb, 3) and block count:
    the sources read, resampled and scaled by their gains, their
    trajectories sampled.  Local to the process: a rank of a mesh that
    fails here fails before any collective."""
    from ..engine.plan import fed_stream
    from ..io.wavio import read_wav_mono

    sources = scene.get("sources", [])
    if not sources:
        raise ValueError("scene has no sources")
    if chunk_blocks is not None and chunk_blocks < 1:
        # callers other than the CLI reach here unvalidated
        raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
    if num_blocks is not None and int(num_blocks) < 1:
        # an explicit blocks=0 errors, not renders nothing or the input length
        raise ValueError(f"blocks ({num_blocks}) must be positive")
    if duration is not None and not float(duration) > 0:
        raise ValueError(f"duration ({duration}) must be positive")
    signals, trajs = [], []
    for s in sources:
        sig, sr = read_wav_mono(s["input"])
        if sr != config.sample_rate:
            # resample like the single-source path: a raw foreign-rate source
            # would mix in pitch-shifted at the wrong duration
            from ..io.resample import resample

            sig = resample(sig, sr, config.sample_rate)
            if not quiet:
                print(f"resampled {s['input']} {sr} -> {config.sample_rate} Hz",
                      file=sys.stderr)
        if len(sig) == 0:
            raise ValueError(f"scene source {s['input']!r} is empty")
        signals.append(sig * np.float32(s.get("gain", 1.0)))
        trajs.append(parse_trajectory(s["trajectory"]))
    if num_blocks is None:
        if duration is not None:
            num_blocks = int(np.ceil(duration / config.block_duration))
        else:
            num_blocks = max(int(np.ceil(len(s) / config.frames_per_buffer)) for s in signals)
    num_blocks = int(num_blocks)
    feds = np.stack([fed_stream(s, num_blocks, config) for s in signals])
    positions = np.stack([t.sample(num_blocks, config) for t in trajs])
    return feds, positions, num_blocks


def render_scene_inputs(inputs, db, config, chunk_blocks: int | None = None, quiet: bool = True,
                        devices: int | None = None, renderer_cache: dict | None = None,
                        device="cuda"):
    """``scene_inputs``' streams and positions rendered into the mix, as
    ``render_scene_spec`` says -> (mix or None, num_blocks)."""
    from ..engine.batch import BatchRenderer
    from ..parallel.mesh import in_mesh

    feds, positions, num_blocks = inputs
    n_sources = feds.shape[0]
    # the chunk quantized to the next power of two >= num_blocks (capped at
    # the request), so short renders share a cache key; the renderer pads
    # the final chunk, so any cb >= num_blocks is one padded chunk
    cb = (None if chunk_blocks is None
          else min(chunk_blocks, 1 << max(0, int(np.ceil(np.log2(num_blocks))))))
    n_mesh = scene_devices(n_sources, devices, quiet)  # warns once when it shrinks
    key = (cb, str(device)) + ((n_mesh,) if n_mesh > 1 else ())
    if renderer_cache is not None and key in renderer_cache:
        br = renderer_cache.pop(key)  # LRU: back of the order
        renderer_cache[key] = br
    else:
        mesh = scene_mesh(n_sources, devices, quiet=True, device=device)
        br = BatchRenderer(db, config, device=device, chunk_blocks=cb, mix=True, mesh=mesh)
        if renderer_cache is not None:
            renderer_cache[key] = br
            while len(renderer_cache) > _SCENE_RENDERER_CACHE_MAX:
                renderer_cache.pop(next(iter(renderer_cache)))
    if not in_mesh(br.mesh):
        return None, num_blocks
    return br.render(feds, positions).reshape(-1, 2), num_blocks


def _write(args, out, config) -> None:
    """Refuse non-finite output, warn on clipping, write the WAV."""
    from ..io.wavio import resolve_float_bits, write_wav

    if not np.isfinite(out).all():
        raise SystemExit("ERROR: non-finite samples in render output")
    clip = np.abs(out) > 1.0
    if clip.any():
        print(f"ALERT! CLIPPING AUDIO! ({int(clip.sum())} samples)", file=sys.stderr)
    write_wav(args.output, out, config.sample_rate,
              bits=resolve_float_bits(args.bits, args.float), float_format=args.float)


def _read_scene(path: str) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except FileNotFoundError:
        raise SystemExit(f"scene file {path!r} not found")
    except json.JSONDecodeError as e:
        raise SystemExit(f"scene file {path!r}: bad JSON: {e}")


def render_scene(args, config, device) -> int:
    """Multi-source render: each source spatialized along its trajectory,
    summed into one stereo mix (per-source gain applied before the render)."""
    scene = _read_scene(args.scene)
    db = load_hrtf(args.hrtf_dir, config, args.quiet)
    t0 = time.time()
    try:
        out, num_blocks = render_scene_spec(
            scene, db, config,
            num_blocks=args.blocks, duration=args.duration,
            chunk_blocks=args.chunk_blocks, quiet=args.quiet, devices=args.devices,
            device=device,
        )
    except (ValueError, FileNotFoundError) as e:
        # a scene source or events file that is missing: one line, like
        # every other scene validation failure
        raise SystemExit(str(e))
    dt = time.time() - t0
    if not is_writer():
        return 0
    _write(args, out, config)
    if not args.quiet:
        audio_s = num_blocks * config.block_duration
        print(
            f"scene: {len(scene['sources'])} sources, {num_blocks} blocks ({audio_s:.2f}s) in "
            f"{dt:.2f}s = {audio_s/dt:.1f}x real time -> {args.output}",
            file=sys.stderr,
        )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.chunk_blocks is not None and args.chunk_blocks < 1:
        raise SystemExit(
            f"--chunk-blocks {args.chunk_blocks} must be a positive block count"
        )
    # an explicit zero or negative length would write a header-only WAV
    if args.blocks is not None and args.blocks < 1:
        raise SystemExit(f"--blocks {args.blocks} must be positive")
    if args.duration is not None and not args.duration > 0:
        raise SystemExit(f"--duration {args.duration} must be positive")
    if args.scene is not None:
        # flags the batched scene pipeline does not implement error out
        # rather than silently not apply
        dropped = []
        if args.reverb is not None or args.reverb_mode != "off":
            dropped.append("-r/--reverb-mode")
        if args.backend != "matmul":
            dropped.append("--backend")
        if args.no_fused:
            dropped.append("--no-fused")
        if args.no_resample:
            dropped.append("--no-resample")
        if args.viz:
            dropped.append("--viz")
        if args.profile_dir is not None:
            dropped.append("--profile-dir")
        if args.initial_old != "0,0":
            dropped.append("--initial-old")
        if args.selftest or args.selftest_full:
            dropped.append("--selftest/--selftest-full")
        if args.type != 0:
            dropped.append("-t/--type")
        if args.input is not None:
            dropped.append("-i/--input")
        if dropped:
            raise SystemExit(
                f"--scene does not support: {', '.join(dropped)} (scene "
                f"sources render through the batched type-0 pipeline; put "
                f"per-source options in the scene JSON)"
            )
    if args.devices is not None and args.devices < 1:
        raise SystemExit(f"--devices {args.devices} must be positive")
    ranks = args.devices or 1
    if ranks > 1 and args.scene is not None:
        # the world is the scene's mesh: the largest count that divides it
        ranks = scene_devices(len(_read_scene(args.scene).get("sources", [])) or 1, ranks)
    elif ranks > 1:
        eff_cb = args.chunk_blocks if args.chunk_blocks is not None else 2048
        if eff_cb % ranks:
            flag = "default" if args.chunk_blocks is None else "--chunk-blocks"
            raise SystemExit(f"{flag} chunk size {eff_cb} must divide evenly over "
                             f"--devices {args.devices}")
    from ..config import DEFAULT_CONFIG
    from ..engine.renderer import resolve_device
    from ..utils.profiling import trace

    try:
        if ranks > 1:
            from ..parallel.mesh import ensure_world

            device = ensure_world(ranks, device=args.device)
        else:
            device = resolve_device(args.device)
    except ValueError as e:
        raise SystemExit(f"--devices {args.devices}: {e}")
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}")
    if not is_writer():
        args.quiet = True  # rank 0 speaks for the world
    config = DEFAULT_CONFIG

    if args.scene is not None:
        return render_scene(args, config, device)
    if args.input is None:
        raise SystemExit("missing -i/--input (or --scene)")
    with trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext():
        return render_file(args, config, device)


def selftest(args, signal, db, config, device) -> None:
    """The engine-vs-oracle sweep gate before the render, with the render's
    backend on the render's device; raises SystemExit on a mismatch."""
    from ..bench.sweep import SCENARIOS, run_benchmark_sweep, run_mover_gate
    from ..engine.renderer import Renderer

    if args.selftest_full:  # the reference's real workload (main.cu:88)
        renderer = Renderer(db, config, device=device, backend=args.backend)
        reports = run_benchmark_sweep(signal, db, config, blocks_per_step=172, num_steps=72,
                                      eps=2e-7, renderer=renderer)
        # plus the per-block mover (the one-hot kernels' gate)
        reports.append(run_mover_gate(signal, db, config, eps=2e-7, renderer=renderer))
    else:
        reports = run_benchmark_sweep(
            signal[: 8 * config.frames_per_buffer * 16], db, config, blocks_per_step=8,
            num_steps=12, eps=2e-7,
            renderer=Renderer(db, config, device=device, chunk_blocks=104,
                              backend=args.backend),
        )
    names = [f"({sa},{se})" for sa, se in SCENARIOS] + ["mover"]
    for name, rep in zip(names, reports):
        if not rep.ok:
            raise SystemExit(f"selftest FAILED at scenario {name}: {rep}")
    if not args.quiet:
        kind = "full benchmarkTesting" if args.selftest_full else "scaled smoke"
        print(f"selftest passed (engine-vs-oracle sweep gate, {kind})", file=sys.stderr)


def write_viz(args, positions, out, config) -> None:
    """The scene, waveform, 2-D player and 3-D player artifacts of a render."""
    from ..viz.html import scene_html
    from ..viz.scene import scene_svg, waveform_svg
    from ..viz.scene3d import scene3d_html

    scene_svg(positions, f"{args.output}.scene.svg", config=config)
    waveform_svg(out, f"{args.output}.wave.svg")
    scene_html(positions, out, f"{args.output}.html", config=config,
               title=f"jefferson_tpu_torch — {Path(args.output).name}")
    scene3d_html(positions, out, f"{args.output}.3d.html", config=config,
                 title=f"jefferson_tpu_torch — {Path(args.output).name} (3-D)")
    if not args.quiet:
        print(f"viz: {args.output}.scene.svg, {args.output}.wave.svg, "
              f"{args.output}.html, {args.output}.3d.html", file=sys.stderr)


def render_file(args, config, device) -> int:
    """The single-source file-to-file render, each host stage a named span."""
    from ..config import ProcessType
    from ..io.wavio import read_wav_mono
    from ..utils.profiling import span

    ptype = ProcessType(args.type)
    with span("cli.read_wav"):
        signal, sr = read_wav_mono(args.input)
    if len(signal) == 0:
        raise SystemExit(f"input WAV {args.input!r} is empty")
    if sr != config.sample_rate:
        if args.no_resample:
            print(f"warning: input rate {sr} != engine rate {config.sample_rate}; "
                  "rendering raw (pitch-shifted, the reference's behavior)", file=sys.stderr)
        else:
            from ..io.resample import resample

            signal = resample(signal, sr, config.sample_rate)
            if not args.quiet:
                print(f"resampled input {sr} -> {config.sample_rate} Hz", file=sys.stderr)

    if args.reverb_mode != "off":
        if args.reverb is None:
            raise SystemExit("--reverb-mode requires -r/--reverb")
        ir, ir_sr = read_wav_mono(args.reverb)
        if ir_sr != config.sample_rate and not args.no_resample:
            # the input signal's rule: a foreign-rate IR convolved raw is a
            # pitch-shifted room of the wrong length
            from ..io.resample import resample

            ir = resample(ir, ir_sr, config.sample_rate)
            if not args.quiet:
                print(f"resampled reverb IR {ir_sr} -> {config.sample_rate} Hz",
                      file=sys.stderr)
        from ..reverb.convolution import convolve_linear, reverb_reference

        t0 = time.time()
        with span("cli.reverb"):
            if args.reverb_mode == "reference":
                signal = reverb_reference(signal, ir, config, backend=args.reverb_backend,
                                          device=device)
            else:
                signal = convolve_linear(signal, ir, config, backend=args.reverb_backend,
                                         device=device)
        if not args.quiet:
            print(f"reverb ({args.reverb_mode}): {len(ir)}-tap IR in {time.time()-t0:.2f}s",
                  file=sys.stderr)

    try:
        traj = parse_trajectory(args.trajectory)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.blocks is not None:
        num_blocks = args.blocks
    elif args.duration is not None:
        num_blocks = int(np.ceil(args.duration / config.block_duration))
    else:
        num_blocks = int(np.ceil(len(signal) / config.frames_per_buffer))
    positions = traj.sample(num_blocks, config)

    if args.initial_old.lower() == "none":
        initial_old = None
    else:
        try:
            initial_old = tuple(float(v) for v in args.initial_old.split(","))
        except ValueError:
            raise SystemExit(
                f"--initial-old needs 'azi,ele' numbers or 'none', got "
                f"{args.initial_old!r}"
            )
        if len(initial_old) != 2:
            # a 1- or 3-tuple would die deep in make_plan
            raise SystemExit(
                f"--initial-old needs exactly 'azi,ele', got {args.initial_old!r}"
            )

    with span("cli.load_hrtf"):
        db = load_hrtf(args.hrtf_dir, config, args.quiet)
    if (args.selftest or args.selftest_full) and not ptype.is_oracle:
        with span("cli.selftest"):
            selftest(args, signal, db, config, device)
    t0 = time.time()
    with span("cli.render"):
        if ptype.is_oracle:
            from ..oracle.reference import render_oracle

            out = render_oracle(signal, db, [tuple(p) for p in positions], config, ptype,
                                initial_old=initial_old)
        else:
            from ..engine.renderer import Renderer

            eff_cb = args.chunk_blocks if args.chunk_blocks is not None else 2048
            mesh = None
            if args.devices and args.devices > 1:  # main() checked eff_cb divides
                from ..parallel.mesh import in_mesh, make_mesh

                mesh = make_mesh(args.devices, ("blk",), device=args.device)
                if not in_mesh(mesh):  # a rank of a larger world: rank 0 writes
                    return 0
            r = Renderer(db, config, device=device, chunk_blocks=eff_cb,
                         backend=args.backend, fused=not args.no_fused,
                         pipeline_fetch=args.pipeline_fetch, mesh=mesh)
            out = r.render(signal, positions, ptype, initial_old=initial_old)
    dt = time.time() - t0
    if not is_writer():
        return 0
    with span("cli.write"):
        _write(args, out, config)
    if args.viz:
        with span("cli.viz"):
            write_viz(args, positions, out, config)
    if not args.quiet:
        audio_s = num_blocks * config.block_duration
        print(
            f"{ptype.name}: {num_blocks} blocks ({audio_s:.2f}s audio) in {dt:.2f}s "
            f"= {audio_s/dt:.1f}x real time -> {args.output}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
