"""The kernel build path under threads: several threads of one process that
first use a library at once build it once and load one handle; and the
render steps' libraries keyed by their geometry (fpb, pad_len).

The host library (``native/native.cpp``) builds with g++, so this runs
without a card; the CUDA sources take the same path with nvcc.
"""

import subprocess
import sys
import threading

import pytest
import torch

from jefferson_tpu_torch import native
from jefferson_tpu_torch.kernels import build

torch.set_num_threads(1)

THREADS = 4


@pytest.fixture
def empty_build_dir(tmp_path, monkeypatch):
    """An empty BUILD_DIR, no library loaded, and a count of compiler runs."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    runs = []
    popen = subprocess.Popen

    def counting_popen(cmd, *a, **kw):
        runs.append(cmd)
        return popen(cmd, *a, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", counting_popen)
    return tmp_path / "build", runs


def _at_once(fn):
    """``fn()`` on THREADS threads released together -> (results, errors)."""
    gate = threading.Barrier(THREADS)
    results, errors = [None] * THREADS, []

    def run(i):
        try:
            gate.wait(timeout=30)
            results[i] = fn()
        except Exception as e:  # collected and asserted on below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(THREADS)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def test_threads_that_first_load_a_library_build_it_once(empty_build_dir):
    build_dir, runs = empty_build_dir
    libs, errors = _at_once(lambda: build.load("native", native.TOOLCHAIN))
    assert errors == []
    assert len(runs) == 1
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].jtn_error is not None  # a loaded library of the right source
    assert sorted(p.suffix for p in build_dir.iterdir()) == [".log", ".so"]


def test_threads_that_build_at_once_leave_one_library_and_no_temporary(empty_build_dir):
    build_dir, runs = empty_build_dir
    paths, errors = _at_once(lambda: build.build("native", native.TOOLCHAIN))
    assert errors == []
    assert len(runs) == 1
    assert len(set(paths)) == 1 and paths[0].exists()
    assert not list(build_dir.glob("*.tmp"))


def test_temporary_file_is_keyed_by_process_and_thread(empty_build_dir, monkeypatch):
    """Two threads that each start a compile name two temporary files."""
    monkeypatch.setattr(build.subprocess, "Popen", lambda cmd, *a, **kw: cmd)
    names = []
    alive = threading.Barrier(2)  # both alive at once: a thread id is reused after exit

    def start():
        alive.wait(timeout=30)
        names.append(build._start("native", native.TOOLCHAIN)[1].name)
        alive.wait(timeout=30)

    threads = [threading.Thread(target=start) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(set(names)) == 2


def test_processes_that_first_load_a_library_at_once_build_it_correctly(tmp_path):
    """The ranks of a mesh on one host are processes: each that finds no
    library compiles its own into a temporary file and replaces the library
    and its log whole, so every rank loads a library of the right source
    and one library, one log and no temporary remain."""
    from jefferson_tpu_torch.parallel import mesh as pm

    code = (
        "import sys, time; from pathlib import Path\n"
        "from jefferson_tpu_torch import native; from jefferson_tpu_torch.kernels import build\n"
        f"build.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "while time.time() < float(sys.argv[1]): time.sleep(0.005)\n"
        "lib = build.load('native', native.TOOLCHAIN)\n"
        "print('loaded', lib.jtn_error is not None)\n"
    )
    import os
    import time

    start = str(time.time() + 3.0)  # every process past its imports before it loads
    env = {**os.environ, "PYTHONPATH": str(pm.REPO_ROOT)}
    failed, outs = pm.spawn([[sys.executable, "-c", code, start]] * THREADS, [env] * THREADS, 120)
    assert not failed, outs
    assert all("loaded True" in out for out in outs), outs
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".log", ".so"]
    assert "native.cpp" in next(tmp_path.glob("*.log")).read_text()


def test_each_geometry_builds_its_own_library():
    """A render step's library is keyed by its geometry: its name carries
    f<fpb>p<pad>, its flags the two defines; the same geometry keeps one
    path; the geometry-free libraries refuse a geometry."""
    paths = {g: build.library_path("fused_step_gather", geometry=g)
             for g in ((128, 1024), (64, 1024), (64, 512), (100, 1024))}
    assert len(set(paths.values())) == 4
    assert paths[(64, 512)].name.startswith("fused_step_gather-f64p512-")
    assert build.library_path("fused_step_gather", geometry=(64, 512)) == paths[(64, 512)]
    assert build.library_path("fused_step_gather") == paths[(128, 1024)]
    assert build.flags("fused_step_onehot", geometry=(441, 1024))[-2:] == (
        "-DJT_FPB=441", "-DJT_PAD=1024")
    assert "-DJT_FPB=441" not in " ".join(build.flags("fused_step_onehot"))
    assert build.library_path("dma_blend").name.startswith("dma_blend-")
    with pytest.raises(ValueError, match="takes no geometry"):
        build.library_path("dma_blend", geometry=(64, 1024))
    assert build.libraries(["dma_blend", "fused_step_onehot"], [(64, 1024), (256, 1024)]) == [
        ("dma_blend", None), ("fused_step_onehot", (64, 1024)), ("fused_step_onehot", (256, 1024))]


def test_a_geometry_library_raises_without_nvcc_and_builds_nothing(tmp_path, monkeypatch):
    """A render step's library at any geometry needs nvcc: without it the
    load raises, no handle is cached and no file is left."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    for geometry in ((64, 1024), (441, 1024)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load("fused_step_gather", geometry=geometry)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(build.GEOMETRIC, geometries=[(256, 1024), (1024, 2048)])
    assert build._loaded == {}
    assert not (tmp_path / "out").exists() or not any((tmp_path / "out").iterdir())
