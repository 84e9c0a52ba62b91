"""Build the port's C++ and CUDA sources at first use and load them with
ctypes.

A ``Toolchain`` says how one kind of source builds: its directory and
suffix, the compiler and its flags.  ``CUDA`` (the default) is each
``csrc/<name>.cu``, compiled by ``nvcc`` for Hopper (``sm_90a``); the host
library ``native/native.cpp`` builds with g++ (``native.TOOLCHAIN``).  Every
source has a plain C interface and builds into
``build/jefferson_tpu_torch/<name>-<hash>.so`` at the root of the checkout,
where the hash covers the source, every local header it includes
(``#include "x.cuh"`` from its directory, followed recursively), the
compiler and the flags, so an edited source or header rebuilds and an
unchanged one loads the cached library.  A build takes seconds because no
PyTorch or Python header is included.  A failed build raises with the
compiler's output; nothing falls back.

The render steps' sources (``GEOMETRIC``: ``fused_step_onehot``,
``fused_step_gather``) are compiled once per geometry, a ``(fpb, pad_len)``
pair passed as ``-DJT_FPB=<fpb> -DJT_PAD=<pad>`` (``csrc/fused_forward.cuh``
derives the bins and the sub-block count from them).  Their library is
``<name>-f<fpb>p<pad>-<hash>.so``, the hash covering the defines with the
other flags, and ``load(name, geometry=...)`` keeps one handle per
geometry; without a geometry they build for ``DEFAULT_GEOMETRY`` (fpb 128,
pad 1024).  The other sources (``dma_blend``, ``assoc_probe``, the host
library) take no geometry.  ``build_all`` starts one compiler per library
at once: each source, and each geometric source at each geometry asked.
Threads of one process build and load under one lock, so two that first
use a library at once build it once and load the same handle; separate
processes (the ranks of a mesh on one host) each compile into a temporary
file of their own and replace the library and its build log atomically.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jefferson_tpu_torch"

# No fast math: the distance ramp needs the precise cosf/sinf.  -Xptxas -v
# writes each kernel's registers and shared memory into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The sources compiled once per (fpb, pad_len), and the geometry they build
# for when none is named.
GEOMETRIC = ("fused_step_onehot", "fused_step_gather")
DEFAULT_GEOMETRY = (128, 1024)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict = {}
# held across the check, the compile and the CDLL: reentrant, as load builds
_LOCK = threading.RLock()


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda, else PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def which(compiler: str) -> str:
    """``compiler`` on PATH, or a RuntimeError naming it."""
    found = shutil.which(compiler)
    if found is None:
        raise RuntimeError(f"{compiler} not found (put it on PATH)")
    return found


@dataclasses.dataclass(frozen=True)
class Toolchain:
    """How one kind of source builds: ``src_dir/<name><suffix>`` compiled
    by ``compiler`` (hashed into the library's key; ``locate`` finds its
    executable) with ``flags``."""

    src_dir: Path
    suffix: str
    compiler: str
    flags: tuple[str, ...]
    locate: Callable[[str], str] = which


def cuda() -> Toolchain:
    """The CUDA sources' toolchain, read from this module's settings."""
    return Toolchain(CSRC, ".cu", "nvcc", NVCC_FLAGS, lambda _: nvcc())


def sources(name: str, toolchain: Toolchain | None = None) -> list[Path]:
    """``<name><suffix>`` and the local headers it includes, recursively,
    in the order first met."""
    tc = toolchain or cuda()
    found, todo = [], [tc.src_dir / f"{name}{tc.suffix}"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (tc.src_dir / inc).is_file():
                todo.append(tc.src_dir / inc)
    return found


def _geometry(name: str, geometry) -> tuple[int, int] | None:
    """The (fpb, pad_len) ``name`` builds for: ``geometry`` or the default
    for a geometric source, None for the others (which refuse one)."""
    if name not in GEOMETRIC:
        if geometry is not None:
            raise ValueError(f"{name} takes no geometry, got {geometry}")
        return None
    fpb, pad = DEFAULT_GEOMETRY if geometry is None else geometry
    return int(fpb), int(pad)


def flags(name: str, toolchain: Toolchain | None = None, geometry=None) -> tuple[str, ...]:
    """The compiler flags of ``name``'s library: the toolchain's, then the
    geometry's defines for a geometric source."""
    tc = toolchain or cuda()
    geo = _geometry(name, geometry)
    return tc.flags if geo is None else (*tc.flags, f"-DJT_FPB={geo[0]}", f"-DJT_PAD={geo[1]}")


def library_path(name: str, toolchain: Toolchain | None = None, geometry=None) -> Path:
    """Where ``<name><suffix>`` builds to, keyed by its sources, compiler
    and flags (a geometric source's defines among them)."""
    tc = toolchain or cuda()
    digest = hashlib.sha256()
    for path in sources(name, tc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join((tc.compiler, *flags(name, tc, geometry))).encode())
    geo = _geometry(name, geometry)
    tag = "" if geo is None else f"-f{geo[0]}p{geo[1]}"
    return BUILD_DIR / f"{name}{tag}-{digest.hexdigest()[:16]}.so"


def _start(name: str, tc: Toolchain, geometry=None):
    """Start the compiler on ``name`` unless its library is built: (out,
    tmp, cmd, process) or None."""
    out = library_path(name, tc, geometry)
    if out.exists():
        return None
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [tc.locate(tc.compiler), *flags(name, tc, geometry), "-o", str(tmp),
           str(tc.src_dir / f"{name}{tc.suffix}")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, cmd, proc


def _finish(name: str, tc: Toolchain, started) -> None:
    out, tmp, cmd, proc = started
    what = f"{tc.src_dir.name}/{name}{tc.suffix}"
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{tc.compiler} on {what} took more than 600 s") from None
    # the log too is replaced whole: ranks that first load a library at
    # once each compile it and write their own
    log = tmp.with_name(tmp.name + ".log")
    log.write_text(" ".join(cmd) + "\n" + stdout + stderr)
    os.replace(log, out.with_suffix(".log"))
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{tc.compiler} failed on {what} (exit {proc.returncode}):\n{stdout}{stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def libraries(names, geometries=None) -> list[tuple[str, tuple[int, int] | None]]:
    """The (name, geometry) libraries of ``names``: a geometric source once
    per geometry of ``geometries`` (default: ``DEFAULT_GEOMETRY`` alone),
    any other source once, in the order given."""
    geos = [DEFAULT_GEOMETRY] if geometries is None else [tuple(g) for g in geometries]
    out = []
    for name in names:
        for geo in (geos if name in GEOMETRIC else [None]):
            if (name, geo) not in out:
                out.append((name, geo))
    return out


def build_all(names, toolchain: Toolchain | None = None, geometries=None) -> list[Path]:
    """Compile every library of ``names`` (``libraries``: a geometric source
    at each of ``geometries``) that is not built yet, all compiler processes
    at once; waits for each and raises on the first failure."""
    tc = toolchain or cuda()
    libs = libraries(names, geometries)
    started = {}
    with _LOCK:
        try:
            for lib in libs:
                started[lib] = _start(lib[0], tc, lib[1])
            for (name, _), job in started.items():
                if job is not None:
                    _finish(name, tc, job)
        finally:
            for job in started.values():  # a failure leaves no compiler running
                if job is not None and job[3].poll() is None:
                    job[3].kill()
                    job[3].communicate()
    return [library_path(name, tc, geo) for name, geo in libs]


def build(name: str, toolchain: Toolchain | None = None, geometry=None) -> Path:
    """Compile ``<name><suffix>`` unless its library is already built."""
    return build_all([name], toolchain, None if geometry is None else [geometry])[0]


def load(name: str, toolchain: Toolchain | None = None, geometry=None) -> ctypes.CDLL:
    """The loaded library of ``<name><suffix>`` (at ``geometry``, a
    geometric source), built on first use."""
    # the kernels' wrappers look their library up on every launch: a CUDA
    # source's name and geometry are its key, with no toolchain built for
    # the lookup
    geo = _geometry(name, geometry)
    key = (name, geo) if toolchain is None else (toolchain, name, geo)
    lib = _loaded.get(key)
    if lib is None:
        with _LOCK:
            lib = _loaded.get(key)
            if lib is None:
                lib = _loaded[key] = ctypes.CDLL(str(build(name, toolchain, geo)))
    return lib
