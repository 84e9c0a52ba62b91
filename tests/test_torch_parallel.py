"""The port's mesh paths (``jefferson_tpu_torch/parallel/mesh.py`` and the
renderers' ``mesh=``) against the unsharded renders and the JAX package's
mesh renders, on CPU.

The in-process cases mirror tests/test_batch_parallel.py's utilities
(``make_mesh``'s validation and factorization, the ranks' slices, the
re-exec of ``ensure_world``) and pin the spawner and the halo.  The
spawned cases run once, in 4 gloo ranks on the CPU: this file is also the
ranks' worker (``python tests/test_torch_parallel.py --worker DIR``, which
imports no jax).  Each rank renders every case of ``CASES`` with
``BatchRenderer(mesh=make_mesh(4))`` or ``Renderer(mesh=make_mesh(4,
("blk",)))``, counts its collectives and spies on ``torch.distributed``'s
own functions; rank 0 keeps the outputs.  Here each output is held to the
port's unsharded render (1e-7 per source, the JAX gate of
tests/test_batch_parallel.py:45; 1e-6 for the mixdown) and to the JAX
package's mesh render on conftest's 8 virtual devices (5e-7, ``TOL_JAX``
of tests/test_torch_renderer.py), arm for arm.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # a spawned rank: the repository root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from jefferson_tpu_torch import bench
from jefferson_tpu_torch.config import DEFAULT_CONFIG as CFG
from jefferson_tpu_torch.engine import batch as tbatch
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.engine.renderer import Renderer, block_halo
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.parallel import mesh as pm
from jefferson_tpu_torch.parallel.record import digest, recorded
from jefferson_tpu_torch.trajectory.trajectory import AzimuthSweep, CircularOrbit, StaticPosition

torch.set_num_threads(1)

TOL_ROWS = 1e-7   # sharded vs unsharded, per source
TOL_MIX = 1e-6    # the mixdown: another sum order
TOL_JAX = 5e-7    # the port vs the JAX package
RANKS = 4
SPAWN_TIMEOUT = 240.0
# torch.distributed's own collectives: the spy wraps each
DIST_CALLS = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
              "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter", "all_to_all",
              "all_to_all_single", "send", "recv", "isend", "irecv", "all_gather_object",
              "broadcast_object_list", "barrier")


def _noise(s, blocks, seed):
    return (np.random.default_rng(seed).standard_normal((s, blocks * 128)) * 0.2).astype(
        np.float32)


def _hold_steps(s, blocks, hold, r=1.0):
    """Sources that step 5 degrees every ``hold`` blocks (tests/test_noxfade.py:301)."""
    step = np.arange(blocks) // hold
    return np.stack([np.stack([(30.0 * i + 5.0 * step) % 360.0, np.full(blocks, 5.0),
                               np.full(blocks, r)], 1) for i in range(s)])


def _held(s, blocks, step=25.0):
    return np.stack([StaticPosition(azi=step * i, ele=5, r=0.8).sample(blocks, CFG)
                     for i in range(s)])


def _wide(s=8, blocks=16, seed=11):
    """tests/test_batch_parallel.py:432: orbits spread over the sphere."""
    rng = np.random.default_rng(seed)
    return np.stack([CircularOrbit(period_s=1.0 + 0.1 * i, ele=rng.uniform(-40, 85), r=1.0,
                                   start_azi=rng.uniform(0, 360)).sample(blocks, CFG)
                     for i in range(s)])


def _mover(blocks):
    return CircularOrbit(period_s=0.4, ele=5, r=1.0).sample(blocks, CFG)


def _sweep(blocks):
    return AzimuthSweep(start_azi=0, ele=0, r=0.5, step_deg=5, blocks_per_step=16,
                        num_steps=-(-blocks // 16)).sample(blocks, CFG)


# name -> (renderer, (signals, positions) builder, chunk_blocks, options, gate
# shrinks, the arms the JAX mesh render takes)
CASES = {
    "plain": ("batch", lambda: bench.moving_scene(8, 32, CFG), 16,
              {"fused": False, "dedup": False}, {}, {("plain", True, None)}),
    "dedup": ("batch", lambda: (_noise(8, 32, 3), _held(8, 32)), 16, {"fused": False}, {},
              {("dedup", True, None)}),
    # the sparse bucket per shard: 2 sources x 64 rows, a crossfade at block 0
    "dedup_fused_sparse": ("batch", lambda: (_noise(8, 64, 6), _hold_steps(8, 64, 1000, 0.9)),
                           64, {}, {}, {("dedup_fused", False, 8)}),
    "dedup_fused_mix": ("batch", lambda: (_noise(8, 32, 3), _held(8, 32)), 16, {"mix": True},
                        {}, {("dedup_fused", True, None)}),
    "onehot_shared": ("batch", lambda: bench.moving_scene(8, 32, CFG), 16, {}, {},
                      {("onehot_shared", True, None)}),
    "onehot_shared_mix": ("batch", lambda: bench.moving_scene(8, 32, CFG), 16, {"mix": True},
                          {}, {("onehot_shared", True, None)}),
    # tests/test_batch_parallel.py:482: grouped tables split by source group
    "onehot_grouped": ("batch", lambda: (_noise(8, 16, 2), _wide()), 16, {"dedup": False},
                       {"MAX_ONEHOT_U": 32, "GROUPED_MIN_TB": 8},
                       {("onehot_grouped", True, None)}),
    # tests/test_batch_parallel.py:629: a new random position every block
    "gather_fused": ("batch", lambda: (_noise(8, 16, 1), bench.wide_positions(8, 16)), 16, {},
                     {}, {("gather_fused", True, None)}),
    # tests/test_batch_parallel.py:747: 6 sources on 4 ranks
    "not_dividing": ("batch", lambda: (_noise(6, 32, 4), _held(6, 32, 15.0)), 16, {}, {},
                     {("dedup", True, None)}),
    # tests/test_batch_parallel.py:275 and :766, on the blk mesh
    "blk_mover": ("single", lambda: (_noise(1, 48, 7)[0], _mover(48)), 16, {}, {},
                  {("plain", True, None)}),
    "blk_sweep": ("single", lambda: (_noise(1, 48, 8)[0], _sweep(48)), 16, {}, {},
                  {("dedup", True, None)}),
    "blk_short": ("single", lambda: (_noise(1, 13, 9)[0],
                                     CircularOrbit(period_s=0.5, ele=5, r=1.0).sample(13, CFG)),
                  16, {}, {}, {("plain", True, None)}),
}


class _Shrinks:
    """The gate shrinks of a case on the port's modules, undone on exit."""

    def __init__(self, shrinks):
        self.shrinks, self.saved = shrinks, []

    def __enter__(self):
        for gate, value in self.shrinks.items():
            mod = tfs if gate == "MAX_ONEHOT_U" else tbatch
            self.saved.append((mod, gate, getattr(mod, gate)))
            setattr(mod, gate, value)

    def __exit__(self, *exc):
        for mod, gate, value in self.saved:
            setattr(mod, gate, value)


def _render(name, db, device, mesh=None, **override):
    """One case through the port -> (output, the renderer)."""
    kind, build, cb, opts, shrinks, _ = CASES[name]
    signals, positions = build()
    with _Shrinks(shrinks):
        if kind == "batch":
            r = BatchRenderer(db, device=device, chunk_blocks=cb, mesh=mesh,
                              **{**opts, **override})
            return r.render(signals, positions), r
        # the unsharded render a block mesh is held to is the unfused one
        r = Renderer(db, device=device, chunk_blocks=cb, fused=False, mesh=mesh)
        return r.render(signals, positions), r


def _spy(log):
    """Wrap torch.distributed's collectives: each call logs its caller's module."""
    import torch.distributed as dist

    saved = {}
    for fname in DIST_CALLS:
        fn = getattr(dist, fname, None)
        if fn is None:
            continue
        saved[fname] = fn

        def wrapped(*a, _fn=fn, _name=fname, **k):
            log.append((_name, sys._getframe(1).f_globals.get("__name__")))
            return _fn(*a, **k)

        setattr(dist, fname, wrapped)
    return saved


def worker(out_dir: str, n: int, device: str, backend, names) -> None:
    """A rank of n: every case on the mesh; the record of each into ``out_dir``."""
    import torch.distributed as dist

    from jefferson_tpu_torch.hrtf.kemar import synthetic_database

    rank_device = pm.ensure_world(n, device=device, backend=backend)
    rank = dist.get_rank()
    db = synthetic_database()
    meshes = {"batch": pm.make_mesh(n, device=device),
              "single": pm.make_mesh(n, ("blk",), device=device)}
    mesh_2d = pm.make_mesh(n, ("src", "blk"), device=device)
    record, outputs = {}, {}
    for name in names:
        log = []
        saved = _spy(log)
        try:
            (out, r), rec = recorded(
                lambda: _render(name, db, rank_device, meshes[CASES[name][0]]), rank_device)
        finally:
            for fname, fn in saved.items():
                setattr(dist, fname, fn)
        record[name] = {**rec, "dispatch": [list(a) for a in r.dispatch], "dist_calls": log,
                        "sha256": digest(out)}
        outputs[name] = out
    refusals = {}
    for what, make in (("batch_2d", lambda: BatchRenderer(db, device="cpu", mesh=mesh_2d)),
                       ("single_2d", lambda: Renderer(db, device="cpu", mesh=mesh_2d)),
                       ("single_chunk", lambda: Renderer(db, device="cpu", chunk_blocks=6,
                                                         mesh=meshes["single"]))):
        try:
            make()
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"cases": record, "refusals": refusals}, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "outputs.npz"), **outputs)
    dist.destroy_process_group()


def spawn_worker(out_dir, n=RANKS, device="cpu", backend=None, names=None):
    """Run the worker in n ranks -> each rank's record, rank 0's outputs."""
    port = pm.free_port()
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", str(out_dir),
           "--ranks", str(n), "--device", device] + (["--backend", backend] if backend else []) + (
        ["--cases", ",".join(names)] if names else [])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    failed, outs = pm.spawn([cmd] * n, [pm.rank_env(env, r, n, port) for r in range(n)],
                            SPAWN_TIMEOUT)
    assert not failed, f"ranks failed: {failed}\n" + "\n".join(outs)
    records = [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) for r in range(n)]
    return records, dict(np.load(Path(out_dir) / "outputs.npz"))


# ---- in process -------------------------------------------------------------


def test_make_mesh_validation_and_factorization():
    """tests/test_batch_parallel.py:200: bad counts and axis ranks raise with
    the JAX messages; 2-D meshes factor near-square (6 -> 2x3, never 1x6)."""
    with pytest.raises(ValueError, match="must be >= 1"):
        pm.make_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        pm.make_mesh(-2, device="cpu")
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        pm.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="only 1-D or 2-D meshes supported"):
        pm.make_mesh(1, ("a", "b", "c"), device="cpu")
    with pytest.raises(RuntimeError, match="needs a world"):
        pm.make_mesh(1, device="cpu")
    assert pm.mesh_shape(6, 2) == (2, 3)
    assert pm.mesh_shape(8, 2) == (2, 4)
    assert pm.mesh_shape(7, 2) == (1, 7)  # primes degrade to 1 x n
    assert pm.mesh_shape(8, 1) == (8,)
    assert pm.mesh_shape(4, 2) == (2, 2)


class _StubMesh:
    """A mesh's shape and this rank's coordinate, without a world."""

    def __init__(self, shape, coord):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.coord = coord

    def size(self):
        return self.mesh.numel()

    def get_coordinate(self):
        return self.coord


def test_mesh_utilities():
    """Each rank's contiguous slice, host-major over both axes of a 2-D
    mesh (jefferson_tpu/parallel/multihost.py:205-210)."""
    assert pm.source_range(_StubMesh((4,), [2]), 8) == (4, 6)
    assert pm.block_range(_StubMesh((4,), [3]), 16) == (12, 16)
    got = [pm.source_range(_StubMesh((2, 2), [h, c]), 8) for h in (0, 1) for c in (0, 1)]
    assert got == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert pm.mesh_position(_StubMesh((2, 3), [1, 2])) == 5
    with pytest.raises(ValueError, match="do not divide over the 4-device mesh"):
        pm.source_range(_StubMesh((4,), [0]), 6)
    with pytest.raises(ValueError, match="not in the mesh"):
        pm.source_range(_StubMesh((2,), None), 4)


def test_ensure_world_reexec_command_and_env(monkeypatch):
    """tests/test_batch_parallel.py:676: outside a world, ensure_world
    re-execs sys.argv as n ranks, every inherited rank variable REPLACED,
    `python -m` kept, and exits with the group's code."""
    import types

    import __main__

    calls = {}

    def fake_spawn(cmds, envs, timeout, capture=True):
        calls["cmds"], calls["envs"], calls["capture"] = cmds, envs, capture
        return [(1, 7)], None

    monkeypatch.setattr(pm, "spawn", fake_spawn)
    monkeypatch.delenv(pm.SPAWNED, raising=False)
    monkeypatch.delenv("TORCHELASTIC_RUN_ID", raising=False)
    # a stale world in the environment: it must not win
    for k, v in (("RANK", "5"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "5"), ("MASTER_PORT", "1"),
                 ("LOCAL_WORLD_SIZE", "2"), ("MASTER_ADDR", "elsewhere")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(__main__, "__spec__", types.SimpleNamespace(name="some.module"),
                        raising=False)
    with pytest.raises(SystemExit) as ei:
        pm.ensure_world(4, device="cpu")
    assert ei.value.code == 7
    assert calls["capture"] is False
    assert [c[:3] for c in calls["cmds"]] == [[sys.executable, "-m", "some.module"]] * 4
    assert all(c[3:] == sys.argv[1:] for c in calls["cmds"])
    ports = {e["MASTER_PORT"] for e in calls["envs"]}
    assert len(ports) == 1 and "1" not in ports
    for r, env in enumerate(calls["envs"]):
        assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"],
                env["MASTER_ADDR"], env[pm.SPAWNED]) == (str(r), "4", str(r), "4", "127.0.0.1",
                                                         "1")
        assert env["PYTHONPATH"].split(os.pathsep)[0] == str(pm.REPO_ROOT)
    # plain-script invocation (no __spec__): sys.argv as it is
    monkeypatch.setattr(__main__, "__spec__", None, raising=False)
    with pytest.raises(SystemExit):
        pm.ensure_world(2, device="cpu")
    assert calls["cmds"] == [[sys.executable] + sys.argv] * 2


def test_no_fallback_hides_the_device_or_the_backend():
    """Without a card: NCCL ranks on `cuda` need n cards, and `cuda` itself
    raises, whatever the backend."""
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        pm.ensure_world(2, device="cuda")
    with pytest.raises(RuntimeError, match="is_available.. is false"):
        pm.init_world("gloo", device="cuda")
    with pytest.raises(ValueError, match="must be >= 1"):
        pm.ensure_world(0, device="cpu")
    assert pm.default_backend("cuda") == "nccl" and pm.default_backend("cpu") == "gloo"


def test_spawn_fails_fast_and_keeps_the_deadline():
    """The first rank to fail ends the group (the rest would wait on it in
    a collective); a group past its deadline is killed and named."""
    py = sys.executable
    t0 = time.monotonic()
    failed, outs = pm.spawn([[py, "-c", "import sys; print('bye'); sys.exit(3)"],
                             [py, "-c", "import time; time.sleep(60)"]], [None, None], 60)
    assert failed == [(0, 3)] and "bye" in outs[0]
    assert time.monotonic() - t0 < 30
    failed, _ = pm.spawn([[py, "-c", "import time; time.sleep(60)"]], [None], 0.5)
    assert failed == [(0, "timeout")]
    assert pm.worst_code([(0, "timeout")]) == 124
    assert pm.worst_code([(1, -9)]) == 1 and pm.worst_code([]) == 0


def test_renderers_refuse_what_is_not_a_mesh(tdb_cpu):
    with pytest.raises(TypeError, match="DeviceMesh"):
        BatchRenderer(tdb_cpu, device="cpu", mesh="src")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Renderer(tdb_cpu, device="cpu", mesh=4)


@pytest.fixture(scope="module")
def tdb_cpu(db):
    import dataclasses

    from jefferson_tpu_torch.convert import database_from_numpy

    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


@pytest.mark.parametrize("cb,ranks", [(16, 1), (16, 4), (8, 2)])
def test_halo_is_the_carried_history(tdb_cpu, monkeypatch, cb, ranks):
    """A chunk's history read from the fed stream (block_halo, which
    render_plan passes to every chunk, meshed or not) is, torch.equal, the
    history the chunk step before it carries out: at every chunk start of
    one rank's share, so at every rank's first block of every chunk."""
    from jefferson_tpu_torch.engine import renderer as trenderer
    from jefferson_tpu_torch.engine.plan import fed_stream

    sig, pos = CASES["blk_mover"][1]()
    chunk = trenderer._fd_complex_chunk
    carried = []

    def spy(*a, **k):
        y, hist = chunk(*a, **k)
        carried.append(hist.clone())
        return y, hist

    monkeypatch.setattr(trenderer, "_fd_complex_chunk", spy)
    # the unsharded render in chunks of one rank's share
    step = cb // ranks
    Renderer(tdb_cpu, device="cpu", chunk_blocks=step, fused=False).render(sig, pos)
    stream = np.concatenate([np.zeros(CFG.history_len, np.float32), fed_stream(sig, len(pos), CFG)])
    assert len(carried) == len(pos) // step
    for i, hist in enumerate(carried):
        halo = block_halo(stream, (i + 1) * step, CFG)
        assert torch.equal(torch.from_numpy(halo), hist)


def test_one_rank_world_equals_the_meshless_render(tdb_cpu):
    """A world of one (init_world outside any launcher): a mesh of one rank
    renders torch.equal to no mesh, in both renderers, and 2-D meshes are
    refused as in the JAX package."""
    import torch.distributed as dist

    pm.init_world(device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        for name in ("dedup_fused_sparse", "onehot_shared_mix", "blk_sweep"):
            want, _ = _render(name, tdb_cpu, "cpu")
            kind = CASES[name][0]
            got, r = _render(name, tdb_cpu, "cpu",
                             pm.make_mesh(1, ("src",) if kind == "batch" else ("blk",),
                                          device="cpu"))
            assert np.array_equal(got, want), name
        mesh_2d = pm.make_mesh(1, ("src", "blk"), device="cpu")
        assert mesh_2d.mesh.shape == (1, 1)
        with pytest.raises(ValueError, match="1-D source mesh"):
            BatchRenderer(tdb_cpu, device="cpu", mesh=mesh_2d)
        with pytest.raises(ValueError, match="1-D .block axis."):
            Renderer(tdb_cpu, device="cpu", mesh=mesh_2d)
    finally:
        dist.destroy_process_group()


# ---- in 4 ranks -------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_worker(tmp_path_factory.mktemp("ranks"))


def _jax_mesh_render(db, name, monkeypatch):
    """The JAX package's render of a case on a 4-device mesh -> (output, arms)."""
    import jefferson_tpu.engine.batch as jbatch
    import jefferson_tpu.pallas.fused_step as jfs
    from jefferson_tpu.engine.renderer import Renderer as JaxRenderer
    from jefferson_tpu.parallel.mesh import make_mesh

    from test_torch_batch import record_jax_arms

    kind, build, cb, opts, shrinks, _ = CASES[name]
    for gate, value in shrinks.items():
        for mod in ((jfs, tfs) if gate == "MAX_ONEHOT_U" else (jbatch, tbatch)):
            monkeypatch.setattr(mod, gate, value)
    signals, positions = build()
    if kind == "batch":
        r = jbatch.BatchRenderer(db, chunk_blocks=cb, mesh=make_mesh(RANKS),
                                 **{"fused": True, **opts})
        arms = record_jax_arms(r)
        return r.render(signals, positions), arms
    r = JaxRenderer(db, chunk_blocks=cb, mesh=make_mesh(RANKS, ("blk",)))
    return r.render(signals, positions), None


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_render_matches_unsharded_and_jax(db, tdb_cpu, ranks, name, monkeypatch):
    records, outputs = ranks
    kind, _, cb, opts, _, arms = CASES[name]
    got = outputs[name]
    # every rank returns the whole result
    assert len({rec["cases"][name]["sha256"] for rec in records}) == 1
    # the same arm on every shard, the JAX mesh render's
    dispatches = {tuple(map(tuple, rec["cases"][name]["dispatch"])) for rec in records}
    assert len(dispatches) == 1
    dispatch = list(dispatches.pop())
    assert set(dispatch) == arms
    assert records[0]["cases"][name]["launches"] == {}  # CPU tensors run the twins
    want_jax, jax_arms = _jax_mesh_render(db, name, monkeypatch)
    if jax_arms is not None:
        assert dispatch == jax_arms
    # the port's unsharded render on the same arm: the block mesh turns
    # fused off, as in JAX, and a mesh that does not divide the sources
    # takes the unfused arms (JAX's replicated XLA path)
    want, r = _render(name, tdb_cpu, "cpu", **({"fused": False} if name == "not_dividing" else {}))
    assert got.shape == want.shape == want_jax.shape
    tol = TOL_MIX if opts.get("mix") else TOL_ROWS
    assert np.abs(got - want).max() <= tol
    if not opts.get("mix"):
        # per source on every arm the CPU twins are row-independent: bit-equal
        assert np.array_equal(got, want), name
    if kind == "single":
        assert dispatch == r.dispatch
    assert np.abs(got - want_jax).max() <= TOL_JAX


@pytest.mark.parametrize("name", list(CASES))
def test_collective_counts_are_pinned(ranks, name):
    """mix=True: one all-reduce a chunk and no gather; mix=False: one gather
    a chunk and no all-reduce; the blk mesh: one gather a chunk; a mesh
    that does not divide the sources: none.  Every call of
    torch.distributed's collectives came from parallel/mesh.py, one each."""
    records, _ = ranks
    kind, _, _, opts, _, _ = CASES[name]
    for rec in records:
        case = rec["cases"][name]
        chunks = len(case["dispatch"])
        if name == "not_dividing":
            want = {"mix_all_reduce": 0, "gather_rows": 0}
        elif opts.get("mix"):
            want = {"mix_all_reduce": chunks, "gather_rows": 0}
        else:
            want = {"mix_all_reduce": 0, "gather_rows": chunks}
        assert case["collectives"] == want
        callers = {module for _, module in case["dist_calls"]}
        assert callers <= {"jefferson_tpu_torch.parallel.mesh"}, callers
        made = [fname for fname, _ in case["dist_calls"]]
        assert made == (["all_reduce"] * want["mix_all_reduce"]
                        + ["all_gather"] * want["gather_rows"])


def test_meshes_the_renderers_refuse(ranks):
    """tests/test_batch_parallel.py:66 and :300: 2-D meshes, and a block
    chunk that does not divide over the mesh."""
    records, _ = ranks
    for rec in records:
        refused = rec["refusals"]
        assert "BatchRenderer needs a 1-D source mesh" in refused["batch_2d"]
        assert "Renderer mesh must be 1-D (block axis)" in refused["single_2d"]
        assert "divide evenly over the 4-device mesh" in refused["single_chunk"]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True)
    ap.add_argument("--ranks", type=int, default=RANKS)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--cases", default=None)
    args = ap.parse_args()
    worker(args.worker, args.ranks, args.device, args.backend,
           args.cases.split(",") if args.cases else list(CASES))
