"""Graft entry points: the flagship step on one device, and the mesh paths'
dryrun in a world of ranks.  Counterpart of ``__graft_entry__.py``.

entry()               -> (fn, args): the batched chunk function of the
                         interpolating binaural pipeline (segment DFT ->
                         HRTF blend -> distance -> tail IDFT -> crossfade)
                         at 4 sources x 16 blocks, its operands on the
                         device.
dryrun_multichip(n)   -> runs n ranks (``torch.distributed``), one step on
                         tiny shapes in SIX stages, each printing its line
                         and its collective counts:
                         (a) a 1-D 'src' mesh: the sources sharded, each
                             rank's rows gathered, the mixdown all-reduced;
                         (b) a 2-D ('src', 'blk') mesh: each rank takes its
                             (sources, blocks) tile of the plain chunk
                             function, its overlap-save history read from
                             the fed stream;
                         (c) BatchRenderer(mesh, dedup=False, fused=True):
                             a fused arm on each rank's shard;
                         (d) the dedup+fused composition on held positions;
                         (e) the CLI's `--scene --devices n` and
                             `-i --devices n` on `--device cpu`;
                         (f) run_multiprocess_dryrun(2, n // 2): a
                             ('host', 'chip') mesh with the mixdown crossing
                             the process boundary.
                         A process that is not a rank of an n-rank world
                         spawns the n ranks itself.

    python -m jefferson_tpu_torch.graft [--device cuda] [--dryrun-device cpu]
        [--backend gloo]

runs entry() on ``--device`` and the dryrun in 4 ranks on ``--dryrun-device`` (the
CPU by default, as the JAX package's dryrun runs on a virtual CPU mesh;
``--dryrun-device cuda --backend gloo`` runs its ranks on the card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from .parallel import mesh as pm

# a sharded render is held to the unsharded one per source (bit-equal on the
# CPU twins, tests/test_batch_parallel.py:45) and in the mix (another sum order)
ROW_TOL, MIX_TOL = 1e-7, 1e-6
# ranks of the command line's dryrun
DRYRUN_RANKS = 4


def _example_inputs(s: int, nb: int, seed: int = 0):
    """(cfg, db, args): s orbiting sources x nb blocks, as NumPy arrays in
    the batched chunk function's order (spectra first)."""
    from .config import DEFAULT_CONFIG
    from .engine.plan import make_plan
    from .hrtf.kemar import synthetic_database
    from .trajectory.trajectory import CircularOrbit

    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    rng = np.random.default_rng(seed)
    spectra = (np.real(db.spectra).astype(np.float32), np.imag(db.spectra).astype(np.float32))
    hists = np.zeros((s, cfg.history_len), np.float32)
    feds = rng.standard_normal((s, nb * cfg.frames_per_buffer)).astype(np.float32) * 0.2
    plans = [make_plan(CircularOrbit(period_s=0.5 + 0.1 * i, ele=5, r=1.0).sample(nb, cfg), cfg)
             for i in range(s)]
    stack = lambda attr: np.stack([getattr(p, attr) for p in plans])
    return cfg, db, (spectra, hists, feds, *(stack(a) for a in (
        "idx_new", "w_new", "idx_old", "w_old", "xfade", "u_hi", "u_lo", "inv_frac")))


def entry(device="cuda"):
    """Flagship forward step on one device: returns (fn, example_args)."""
    from .engine.batch import batched_chunk_fn

    s, nb = 4, 16
    cfg, _, (spectra, *rest) = _example_inputs(s, nb)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    fn = batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True)
    return fn, (tuple(put(a) for a in spectra), *(put(a) for a in rest))


def _check(what: str, got, want, tol: float) -> float:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want.cpu() if isinstance(want, torch.Tensor) else want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError(f"{what}: {got.shape} not finite / not {want.shape}")
    d = float(np.abs(got - want).max())
    if d > tol:
        raise RuntimeError(f"{what}: max|diff| {d:.3e} vs unsharded over {tol:.0e}")
    return d


def _stage_src(mesh, device, nb: int) -> str:
    """(a): the sources sharded over a 1-D mesh, rows gathered, mix reduced."""
    from .engine.batch import batched_chunk_fn, mix_sources

    s = 2 * mesh.size()
    cfg, _, (spectra, hists, *rest) = _example_inputs(s, nb)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    step = batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True)
    lo, hi = pm.source_range(mesh, s)
    pm.reset_collectives()
    outs, new_hists = step(tuple(put(a) for a in spectra), put(hists[lo:hi]),
                           *(put(a[lo:hi]) for a in rest))
    mixed = pm.mix_all_reduce(mix_sources(outs), mesh)
    rows = pm.gather_rows(outs, mesh)
    counts = dict(pm.collectives)
    want, _ = step(tuple(put(a) for a in spectra), put(hists), *(put(a) for a in rest))
    if tuple(new_hists.shape) != (hi - lo, cfg.history_len):
        raise RuntimeError(f"(a) carried histories {tuple(new_hists.shape)}")
    d_rows = _check("(a) rows", rows, want, ROW_TOL)
    d_mix = _check("(a) mix", mixed, mix_sources(want), MIX_TOL)
    return (f"dryrun 1-D OK: {s} sources sharded over {mesh.size()} ranks, one step of {nb} "
            f"blocks, rows max|diff| {d_rows:.2e}, mixdown {d_mix:.2e}, collectives {counts}")


def _stage_src_blk(mesh, device) -> str:
    """(b): a 2-D ('src', 'blk') mesh, each rank one (sources, blocks)
    tile, its history read from the fed stream."""
    from .engine.batch import batched_chunk_fn, mix_sources

    n_src, n_blk = mesh.mesh.shape
    s, nb = 2 * n_src, 2 * n_blk
    cfg, _, (spectra, hists, feds, *per_block) = _example_inputs(s, nb)
    fpb, hl = cfg.frames_per_buffer, cfg.history_len
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    sl, bl = s // n_src, nb // n_blk
    i0 = mesh.get_local_rank("src") * sl
    b0 = mesh.get_local_rank("blk") * bl
    streams = np.concatenate([hists, feds], axis=1)
    halo = streams[i0 : i0 + sl, b0 * fpb : b0 * fpb + hl]
    fed = feds[i0 : i0 + sl, b0 * fpb : (b0 + bl) * fpb]
    tile_step = batched_chunk_fn(cfg, num_blocks=bl, with_xfade=True)
    pm.reset_collectives()
    tile, _ = tile_step(tuple(put(a) for a in spectra), put(halo), put(fed),
                        *(put(a[i0 : i0 + sl, b0 : b0 + bl]) for a in per_block))
    mixed = pm.gather_rows(pm.mix_all_reduce(mix_sources(tile), mesh, "src"), mesh, "blk")
    rows = pm.gather_rows(pm.gather_rows(tile.transpose(0, 1), mesh, "blk").transpose(0, 1),
                          mesh, "src")
    counts = dict(pm.collectives)
    want, _ = batched_chunk_fn(cfg, num_blocks=nb, with_xfade=True)(
        tuple(put(a) for a in spectra), put(hists), put(feds), *(put(a) for a in per_block))
    d_rows = _check("(b) rows", rows, want, ROW_TOL)
    d_mix = _check("(b) mix", mixed, mix_sources(want), MIX_TOL)
    return (f"dryrun 2-D OK: ({s} src x {nb} blk) over a {n_src}x{n_blk} ('src','blk') mesh, "
            f"rows max|diff| {d_rows:.2e}, mixdown {d_mix:.2e}, collectives {counts}")


def _stage_renderer(mesh, device, nb: int, hold: bool) -> str:
    """(c) and (d): BatchRenderer on the source mesh, a fused arm on every
    rank's shard, against the unsharded render."""
    from .config import DEFAULT_CONFIG
    from .engine.batch import BatchRenderer
    from .hrtf.kemar import synthetic_database
    from .trajectory.trajectory import CircularOrbit, StaticPosition

    cfg = DEFAULT_CONFIG
    db = synthetic_database(cfg)
    s = 2 * mesh.size()
    rng = np.random.default_rng(0)
    signals = (rng.standard_normal((s, nb * cfg.frames_per_buffer)) * 0.1).astype(np.float32)
    if hold:
        positions = np.stack([StaticPosition(azi=30 * i, ele=5, r=0.8).sample(nb, cfg)
                              for i in range(s)])
    else:
        positions = np.stack([CircularOrbit(period_s=0.3 + 0.1 * i, ele=5, r=1.0).sample(nb, cfg)
                              for i in range(s)])
    opts = dict(chunk_blocks=nb, dedup=hold, fused=True)
    br = BatchRenderer(db, cfg, device=device, mesh=mesh, **opts)
    pm.reset_collectives()
    got = br.render(signals, positions)
    counts = dict(pm.collectives)
    want = BatchRenderer(db, cfg, device=device, **opts).render(signals, positions)
    arms = {arm for arm, _, _ in br.dispatch}
    if hold and arms != {"dedup_fused"}:
        raise RuntimeError(f"(d) dedup+fused composition not taken: {br.dispatch}")
    if not hold and not arms <= {"onehot_shared", "onehot_grouped", "gather_fused"}:
        raise RuntimeError(f"(c) fused arm not taken: {br.dispatch}")
    d = _check("(c/d) render", got, want, ROW_TOL)
    what = ("dedup+fused, position-holding sources" if hold
            else f"fused ({', '.join(sorted(arms))})")
    return (f"dryrun {'(d)' if hold else '(c)'} OK: {s} sources through the {what} arm, one "
            f"shard per rank, max|diff| vs unsharded {d:.2e}, collectives {counts}")


def _stage_cli(n: int) -> str:
    """(e): the CLI's two mesh forms, `--scene --devices n` (sources) and
    `-i --devices n` (blocks), on `--device cpu`; rank 0 reads the WAVs."""
    import torch.distributed as dist

    from .cli import main as cli_main
    from .io.wavio import read_wav, write_wav

    cfg_sr, fpb = 44100, 128
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "in.wav")
        sig = (rng.standard_normal(4096) * 0.2).astype(np.float32)
        write_wav(wav, np.stack([sig, sig], 1), cfg_sr)
        scene = {"sources": [{"input": wav, "trajectory": f"orbit:period=0.5,start={i * 45}"}
                             for i in range(2 * n)]}
        scene_path = os.path.join(td, "scene.json")
        with open(scene_path, "w") as f:
            json.dump(scene, f)
        pm.reset_collectives()
        out_scene = os.path.join(td, "scene.wav")
        rc = cli_main.main(["--scene", scene_path, "-o", out_scene, "--blocks", "16",
                            "--chunk-blocks", "16", "--devices", str(n), "--quiet",
                            "--device", "cpu"])
        out_single = os.path.join(td, "single.wav")
        rc2 = cli_main.main(["-i", wav, "-o", out_single, "--blocks", "16", "--chunk-blocks",
                             str(2 * n), "--devices", str(n), "--trajectory", "orbit:period=0.5",
                             "--quiet", "--device", "cpu"])
        counts = dict(pm.collectives)
        if (rc, rc2) != (0, 0):
            raise RuntimeError(f"(e) the CLI exited {rc}, {rc2}")
        if dist.get_rank() == 0:
            for path in (out_scene, out_single):
                y, _ = read_wav(path)
                if y.shape[0] != 16 * fpb or not np.isfinite(y).all():
                    raise RuntimeError(f"(e) {path}: {y.shape} not finite / not 16 blocks")
    return (f"dryrun CLI OK: `--scene --devices {n}` (src mesh) and `-i --devices {n}` (blk "
            f"mesh) render through the CLI, collectives {counts}")


def _dryrun_inprocess(n: int, device, backend: str | None) -> None:
    """Run the stages as one rank of an n-rank world."""
    import torch.distributed as dist

    rank_device = pm.init_world(backend, device=device)
    if dist.get_world_size() != n:
        raise RuntimeError(f"the dryrun runs in a world of {n} ranks, not "
                           f"{dist.get_world_size()}")
    lines = []
    mesh1 = pm.make_mesh(n, ("src",), device=device)
    lines.append(_stage_src(mesh1, rank_device, 8))
    if n > 1:
        lines.append(_stage_src_blk(pm.make_mesh(n, ("src", "blk"), device=device), rank_device))
    lines.append(_stage_renderer(mesh1, rank_device, 8, hold=False))
    lines.append(_stage_renderer(mesh1, rank_device, 8, hold=True))
    lines.append(_stage_cli(n))
    if dist.get_rank() == 0:
        for line in lines:
            print(line, flush=True)
        # (f) its own world of 2 processes x n/2 devices
        from .parallel.multihost import run_multiprocess_dryrun

        n_local = max(1, n // 2)
        run_multiprocess_dryrun(2, n_local, device=torch.device(device).type, backend=backend)
        print(f"dryrun multi-process OK: 2 processes x {n_local} devices, ('host','chip') mesh, "
              f"cross-process all-reduce mixdown verified", flush=True)


def dryrun_multichip(n_devices: int, *, device="cpu", backend: str | None = None,
                     timeout: float = 900.0) -> None:
    """Run the six dryrun stages in ``n_devices`` ranks on ``device``:
    in-process when this process is a rank of such a world, else in n
    spawned ranks (raising with their output if any fails)."""
    import torch.distributed as dist

    if dist.is_initialized():
        _dryrun_inprocess(n_devices, device, backend)
        return
    backend = backend or pm.default_backend(device)
    port = pm.free_port()
    cmd = [sys.executable, "-m", "jefferson_tpu_torch.graft", "--dryrun", str(n_devices),
           "--dryrun-device", torch.device(device).type, "--backend", backend]
    print(f"dryrun_multichip: {n_devices} ranks ({backend}, {torch.device(device).type})",
          flush=True)
    failed, outs = pm.spawn([cmd] * n_devices,
                            [pm.rank_env(os.environ, r, n_devices, port) for r in range(n_devices)],
                            timeout)
    if failed:
        raise RuntimeError(f"dryrun ranks failed: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{out}" for r, out in enumerate(outs)))
    for out in outs:
        if out.strip():
            print(out, end="" if out.endswith("\n") else "\n", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where entry() runs (the card by default)")
    ap.add_argument("--dryrun-device", choices=["cuda", "cpu"], default="cpu",
                    help="where the dryrun's ranks run (the CPU by default)")
    ap.add_argument("--backend", default=None,
                    help="the dryrun's backend: nccl (the card's default) or gloo")
    ap.add_argument("--dryrun", type=int, default=None,
                    help="run the dryrun's stages as a rank of a world of this many")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        _dryrun_inprocess(args.dryrun, args.dryrun_device, args.backend)
        return 0
    from .engine.renderer import resolve_device

    device = resolve_device(args.device)
    fn, fargs = entry(device)
    out, _ = fn(*fargs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"entry() run OK on {device}: {tuple(out.shape)}")
    dryrun_multichip(DRYRUN_RANKS, device=args.dryrun_device, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
