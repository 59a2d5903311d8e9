"""Fused chains on the card: wrapper of kernel K2 (``csrc/chain_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur.filter_chain_planar_pallas``.
K2 stands for its fused kernel ``_chain_mxu_kernel`` (both band forms): it
runs a chain of gaussian3/5/7/9, sharpen, edge and point stages (invert,
solarize, posterize1-8, registered LUTs) over planar ``(N, H, W)`` uint8
with one read and one write, every stage an exact integer op. Every other
chain (one with a rank-family or registered-kernel stage) goes to K3
(:mod:`hipe_tpu_torch.ops.cuda_rank_chain`), as ``hipe_tpu`` sends it to
``_chain_kernel``.

:func:`filter_chain_rows_cuda` is K2's rows entry, the counterpart of
``filter_chain_rows_pallas``: the same band and point chains over
interleaved rows ``(B, H, W*C)``, a whole pixel clamped at the W edges.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain PyTorch chain
(:func:`hipe_tpu_torch.ops.blur.filter_chain`,
:func:`hipe_tpu_torch.ops.blur.filter_chain_rows`), which is also what the
kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import blur as tblur

# Output rows per thread block when the caller names none; the runner's
# autotune sweeps the alternatives.
DEFAULT_ROWS_PER_BLOCK = 32

# Stage op codes of K2 (enum Op in csrc/chain_planar.cu).
OP_GAUSSIAN, OP_SHARPEN, OP_EDGE, OP_INVERT, OP_SOLARIZE, OP_POSTERIZE, OP_LUT = range(7)
_FIXED_OPS = {"sharpen": OP_SHARPEN, "edge": OP_EDGE, "invert": OP_INVERT,
              "solarize": OP_SOLARIZE}


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hipe_chain_planar_u8.argtypes = [vp, vp, ci, ci, ci, vp, ci, vp, ci,
                                         ci, ci, vp]
    lib.hipe_chain_planar_u8.restype = ci
    lib.hipe_chain_rows_u8.argtypes = [vp, vp, ci, ci, ci, ci, vp, ci, vp, ci,
                                       ci, ci, vp]
    lib.hipe_chain_rows_u8.restype = ci
    lib.hipe_cuda_error_string.argtypes = [ci]
    lib.hipe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def encode_program(names: Sequence[str]) -> tuple[list[int], list[np.ndarray]]:
    """K2's stage program for a chain: ``[op0, arg0, op1, arg1, ...]``, and
    the LUT tables its ``lut`` stages index, in order of first use."""
    program: list[int] = []
    tables: list[np.ndarray] = []
    lut_index: dict[str, int] = {}
    for name in names:
        if name in tblur.LUT_STAGES:
            if name not in lut_index:
                lut_index[name] = len(tables)
                tables.append(tblur.LUT_STAGES[name])
            program += [OP_LUT, lut_index[name]]
        elif name in tblur.GAUSSIANS:
            program += [OP_GAUSSIAN, tblur.FILTER_RADIUS[name]]
        elif name.startswith("posterize") and name in tblur.POINT_STAGES:
            program += [OP_POSTERIZE, tblur.posterize_mask(int(name[len("posterize"):]))]
        elif name in _FIXED_OPS:
            program += [_FIXED_OPS[name], 0]
        else:
            raise KeyError(name)
    return program, tables


@functools.lru_cache(maxsize=64)
def _device_program(names: tuple, device: torch.device, lut_bytes: tuple):
    """The chain's program (host ints, passed by value at launch) and its
    LUTs as one ``(n_luts, 256)`` uint8 device tensor, built once per
    (chain, device, LUT contents), so no copy runs on a launch."""
    program, tables = encode_program(names)
    prog = (ctypes.c_int * len(program))(*program)
    luts = None
    if tables:
        luts = torch.from_numpy(np.stack(tables)).to(device)
    return prog, luts


def check_stages(names: Sequence[str]) -> tuple:
    """The chain as a tuple, or KeyError naming what is not a stage."""
    names = tuple(names)
    unknown = [n for n in names if n not in tblur.FILTERS]
    if unknown:
        raise KeyError(f"unknown filter stage(s) {unknown!r} (ported: "
                       f"{sorted(tblur.FILTERS)}); ROADMAP.md lists what is "
                       "still to be ported")
    if not names:
        raise ValueError("a chain needs at least one stage")
    return names


def is_band_chain(names: Sequence[str]) -> bool:
    """Whether K2 takes the chain: every stage a gaussian, sharpen, edge or
    point stage. This is ``hipe_tpu``'s ``mxu_ok`` rule without its
    ``H % 8`` clause (K2 takes any H); every other chain runs K3."""
    return all(nm in tblur.GAUSSIANS or nm in ("sharpen", "edge")
               or nm in tblur.POINT_STAGES for nm in names)


def check_planar_call(x: torch.Tensor, names: Sequence[str], h_pad: bool,
                      rows_per_block: int | None,
                      out: torch.Tensor | None) -> tuple[tuple, int, int]:
    """Check a chain call on planar ``(N, H, W)`` uint8 (or rows ``(B, H,
    W*C)``) for K2 or K3.

    Returns the chain as a tuple, the output rows and the rows per block;
    raises on anything the kernels do not take.
    """
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise TypeError(
            f"expected a 3-D uint8 tensor, got {x.dtype} of shape {tuple(x.shape)}")
    names = check_stages(names)
    n, h, w = x.shape
    r = tblur.chain_radius(names)
    ho = h if h_pad else h - 2 * r
    if ho < 1:
        raise ValueError(f"valid mode needs H > {2 * r} for {names}, got H={h}")
    rpb = DEFAULT_ROWS_PER_BLOCK if rows_per_block is None else int(rows_per_block)
    if rpb < 1:
        raise ValueError(f"rows_per_block must be >= 1, got {rows_per_block}")
    if out is not None:
        if (tuple(out.shape) != (n, ho, w) or out.dtype != torch.uint8
                or out.device != x.device or not out.is_contiguous()):
            raise ValueError(
                f"out must be a contiguous uint8 {(n, ho, w)} tensor on "
                f"{x.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
        if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
            raise ValueError("out shares memory with x; the chain is out-of-place")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return names, ho, rpb


def filter_chain_planar_cuda(
    x: torch.Tensor,
    names: Sequence[str],
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused chain of any stages over planar ``(N, H, W)`` uint8.

    Every stage clamps at the edges of its own input; with ``h_pad`` the
    output is ``(N, H, W)``, without it ``(N, H - 2R, W)`` with R the
    chain's total radius (the valid interior). ``out``, if given, receives
    the result and must not share memory with ``x``. ``rows_per_block`` is
    the kernel's launch knob (output rows per thread block). A band chain
    (:func:`is_band_chain`) runs K2, any other chain K3.
    """
    if not is_band_chain(names):  # unknown names too: K3's checks raise
        from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda

        return rank_chain_planar_cuda(x, names, h_pad=h_pad,
                                      rows_per_block=rows_per_block, out=out)
    names, ho, rpb = check_planar_call(x, names, h_pad, rows_per_block, out)
    if x.device.type == "cpu":
        y = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    n, h, w = x.shape
    lut_bytes = tuple(tblur.LUT_STAGES[nm].tobytes() for nm in names
                      if nm in tblur.LUT_STAGES)
    prog, luts = _device_program(names, x.device, lut_bytes)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = lib.hipe_chain_planar_u8(
            x.data_ptr(), out.data_ptr(), n, h, w, ctypes.addressof(prog),
            len(names), None if luts is None else luts.data_ptr(),
            0 if luts is None else luts.shape[0], int(h_pad), rpb,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.hipe_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"chain_planar_u8 launch failed for {(n, h, w)} {names} "
            f"h_pad={h_pad} rows_per_block={rpb}: {msg} (cudaError {rc})")
    filter_chain_planar_cuda.launches += 1
    return out


filter_chain_planar_cuda.launches = 0


def filter_chain_rows_cuda(
    rows: torch.Tensor,
    channels: int,
    names: Sequence[str],
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused band/point chain over interleaved rows ``(B, H, W*C)`` uint8.

    K2's rows entry, the counterpart of ``filter_chain_rows_pallas``: it
    takes band chains only (:func:`is_band_chain`), as that entry does.
    Every stage clamps at the edges of its own input, a whole pixel at the
    W edges; ``h_pad``, ``rows_per_block`` and ``out`` as in
    :func:`filter_chain_planar_cuda`.
    """
    names = check_stages(names)
    if not is_band_chain(names):
        raise ValueError(f"K2's rows entry takes band and point chains only, not "
                         f"{names}; other chains run planar (Pipeline.apply_rows)")
    names, ho, rpb = check_planar_call(rows, names, h_pad, rows_per_block, out)
    if channels < 1 or rows.shape[2] % channels:
        raise ValueError(f"rows {tuple(rows.shape)} are not (B, H, W*{channels})")
    if rows.device.type == "cpu":
        y = tblur.filter_chain_rows(rows, channels, names, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    b, h, lanes = rows.shape
    lut_bytes = tuple(tblur.LUT_STAGES[nm].tobytes() for nm in names
                      if nm in tblur.LUT_STAGES)
    prog, luts = _device_program(names, rows.device, lut_bytes)
    if out is None:
        out = torch.empty((b, ho, lanes), dtype=torch.uint8, device=rows.device)
    lib = _kernel_lib()
    with torch.cuda.device(rows.device):
        rc = lib.hipe_chain_rows_u8(
            rows.data_ptr(), out.data_ptr(), b, h, lanes // channels, channels,
            ctypes.addressof(prog), len(names),
            None if luts is None else luts.data_ptr(),
            0 if luts is None else luts.shape[0], int(h_pad), rpb,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.hipe_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"chain_rows_u8 launch failed for {(b, h, lanes)} C={channels} {names} "
            f"h_pad={h_pad} rows_per_block={rpb}: {msg} (cudaError {rc})")
    filter_chain_rows_cuda.launches += 1
    return out


filter_chain_rows_cuda.launches = 0
