"""Build the port's CUDA kernels at first use and load them with ctypes.

The counterpart of ``hipe_tpu.io_.jpeg``'s build-at-first-use of its
``csrc/``: every ``hipe_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/hipe_tpu_torch/<key>/libhipe_tpu_torch.so \\
         hipe_tpu_torch/csrc/*.cu

``<key>`` hashes the sources, so an edited kernel builds anew and an
unchanged one is reused. ``build/`` is git-ignored. The library includes no
PyTorch header, which keeps the build to seconds. ``nvcc`` is looked up on
``PATH``, then under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "hipe_tpu_torch"
LIB_NAME = "libhipe_tpu_torch.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """``build/hipe_tpu_torch/<hash of csrc/*.cu, *.cuh and the flags>``."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in "
        f"{os.path.join(home, 'bin')}): the CUDA kernels of hipe_tpu_torch "
        "are built from source at first use and need the CUDA toolkit"
    )


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return it.

    ``-Xptxas -v`` reports each kernel's registers and shared memory; the
    compiler's output is kept beside the library as ``build.log``.
    """
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *(str(s) for s in srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr.strip()}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    return ctypes.CDLL(str(build()))
