"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``build/jefferson_tpu_torch/<name>-<hash>.so`` at
the root of the checkout, where the hash covers the source, every local
header it includes (``#include "x.cuh"`` from ``csrc/``, followed
recursively) and the flags, so an edited source or header rebuilds and an
unchanged one loads the cached library.  A build takes seconds because no
PyTorch header is included.  A failed build raises with the compiler's
output; nothing falls back.  ``build_all`` starts one nvcc per source at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jefferson_tpu_torch"

# No fast math: the distance ramp needs the precise cosf/sinf.  -Xptxas -v
# writes each kernel's registers and shared memory into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda, else PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, recursively,
    in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (CSRC / inc).is_file():
                todo.append(CSRC / inc)
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its sources and flags."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``name`` unless its library is built: (out, tmp, cmd,
    process) or None."""
    out = library_path(name)
    if out.exists():
        return None
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, cmd, proc


def _finish(name: str, started) -> None:
    out, tmp, cmd, proc = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc on csrc/{name}.cu took more than 600 s") from None
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout + stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def build_all(names) -> list[Path]:
    """Compile every ``csrc/<name>.cu`` that is not built yet, all nvcc
    processes at once; waits for each and raises on the first failure."""
    names = list(names)
    started = {}
    try:
        for name in names:
            started[name] = _start(name)
        for name, job in started.items():
            if job is not None:
                _finish(name, job)
    finally:
        for job in started.values():  # a failure leaves no compiler running
            if job is not None and job[3].poll() is None:
                job[3].kill()
                job[3].communicate()
    return [library_path(name) for name in names]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
