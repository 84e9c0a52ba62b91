"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``build/jefferson_tpu_torch/<name>-<hash>.so`` at
the root of the checkout, where the hash covers the source and the flags,
so an edited source rebuilds and an unchanged one loads the cached library.
A build takes seconds because no PyTorch header is included.  A failed
build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its contents and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
