"""Build the port's CUDA kernels at first use and load them with ctypes.

The counterpart of ``hipe_tpu.io_.jpeg``'s build-at-first-use of its
``csrc/``: every ``hipe_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one process a source, all started together, and the
objects are linked into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \\
         -Xcompiler -fPIC -o build/hipe_tpu_torch/<key>/<source>.o <source>.cu
    nvcc -shared -o build/hipe_tpu_torch/<key>/libhipe_tpu_torch.so *.o

``<key>`` hashes the sources, so an edited kernel builds anew and an
unchanged one is reused. ``build/`` is git-ignored. The library includes no
PyTorch header, which keeps the build to seconds. ``nvcc`` is looked up on
``PATH``, then under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).

:func:`entry` is the one way a wrapper launches a kernel: it declares a C
entry point's argument types once and returns its launcher, which runs on
the tensor's device and current stream, raises on a CUDA error and counts
the launch in the wrapper's ``launches``, which ``profiling/trace.py``
reads a profiler session.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from hipe_tpu_torch.profiling import trace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "hipe_tpu_torch"
LIB_NAME = "libhipe_tpu_torch.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# Serializes the first build: the objects are named by process id, so two
# threads of one process (the engine's lanes) must not build at once.
_BUILD_LOCK = threading.Lock()


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

    One ``nvcc`` a source, all at once, then one link. ``-Xptxas -v``
    reports each kernel's registers and shared memory; the compilers'
    output is kept beside the library as ``build.log``.
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
    tag = f"{os.getpid()}.tmp"
    cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", str(out_dir / f"{src.stem}.{tag}.o"), str(src)]
            for src in srcs]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [p.communicate()[0] for p in procs]
    objs = [cmd[cmd.index("-o") + 1] for cmd in cmds]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
    failed = [(cmd, out) for cmd, p, out in zip(cmds, procs, outputs) if p.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outputs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, outputs[-1]))
    (out_dir / "build.log").write_text("".join(
        " ".join(cmd) + "\n" + out for cmd, out in zip([*cmds, link], outputs)))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out.strip()}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def _load() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call (by one thread)."""
    with _BUILD_LOCK:
        return _load()


# Argument types of the entry points: a pointer, an int, a 64-bit size.
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _error_string():
    fn = load_library().hipe_cuda_error_string
    fn.argtypes, fn.restype = [I], ctypes.c_char_p
    return fn


class Launch:
    """The launcher of one C entry point of the kernels' library.

    Every entry point takes its arguments, then the CUDA stream, and returns
    a ``cudaError_t``. The library loads, and the argument types are
    declared, at the first launch (or :meth:`bind`), never at import.
    """

    def __init__(self, owner, symbol: str, argtypes):
        self.owner, self.symbol, self.argtypes = owner, symbol, [*argtypes, P]
        self._fn = None

    def bind(self):
        """The entry point, its argument types declared."""
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, I
            self._fn = fn
        return self._fn

    def __call__(self, x: torch.Tensor, describe, *args) -> None:
        """Launch on ``x``'s device and its current stream; on a CUDA error
        raise ``RuntimeError`` naming ``describe()``, the error and its code."""
        fn = self._fn or self.bind()
        with torch.cuda.device(x.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = _error_string()(rc).decode()
            raise RuntimeError(f"{describe()}: {msg} (cudaError {rc})")
        self.owner.launches += 1


def entry(symbol: str, *argtypes):
    """Decorator: the wrapper launches the C entry point ``symbol``, taking
    ``argtypes`` before the stream, through its ``launch`` (a
    :class:`Launch`), which counts each launch in its ``launches``; the
    profiler sessions of ``profiling/trace.py`` read that count."""
    def declare(wrapper):
        wrapper.launches = 0
        wrapper.launch = Launch(wrapper, symbol, argtypes)
        return trace.counts_launches(wrapper)
    return declare
