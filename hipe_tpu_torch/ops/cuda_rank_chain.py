"""Rank-family and registered-kernel chains on the card: wrapper of kernel K3
(``csrc/rank_chain_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur.filter_chain_planar_pallas``'s
non-MXU branch and its kernel ``_chain_kernel`` (both ``int16_ranks``
settings: a TPU packing knob that computes the same integers). K3 runs any
chain of stages over planar ``(N, H, W)`` uint8 with one read and one
write: median, erode, dilate, registered rank stages (``median5/7/9``,
``erode5``, ``dilate5``, ``--rank``), registered kernel stages (the
``pil_*`` presets, ``--kernel``), and every band and point stage of K2.
:func:`hipe_tpu_torch.ops.cuda_chain.filter_chain_planar_cuda` sends it every
chain that is not a band chain.

For a CUDA tensor :func:`rank_chain_planar_cuda` launches K3 or raises; for
a CPU tensor it runs the plain PyTorch chain
(:func:`hipe_tpu_torch.ops.blur.filter_chain`), which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import cuda_chain

# K3's own stage op codes (enum Op in csrc/chain_stages.cuh); band and point
# stages keep K2's (cuda_chain.OP_*).
OP_MEDIAN, OP_ERODE, OP_DILATE, OP_RANK, OP_KERNEL = range(7, 12)
_RANK3_OPS = {"median": OP_MEDIAN, "erode": OP_ERODE, "dilate": OP_DILATE}


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hipe_rank_chain_planar_u8.argtypes = [vp, vp, ci, ci, ci, vp, ci, vp, ci,
                                              vp, ci, ci, ci, vp]
    lib.hipe_rank_chain_planar_u8.restype = ci
    lib.hipe_cuda_error_string.argtypes = [ci]
    lib.hipe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def encode_program(names: Sequence[str]) -> tuple[list[int], list[np.ndarray], list[int]]:
    """K3's stage program ``[op0, arg0, size0, ...]``, the LUT tables its
    ``lut`` stages index, and its tap table.

    Band and point stages take K2's op codes and arguments with size 0. A
    rank stage is ``(OP_RANK, rank, size)``; median, erode and dilate are
    ``(op, 0, 0)``. A kernel stage is ``(OP_KERNEL, offset, size)``, where
    its spec ``[scale, off2, flipped taps row-major]`` starts at ``offset``
    of the tap table; each kernel's spec is stored once, in order of first
    use, and so is each LUT.
    """
    own = {n for n in names
           if n in _RANK3_OPS or n in tblur.RANK_STAGES or n in tblur.KERNEL_STAGES}
    k2_program, tables = cuda_chain.encode_program([n for n in names if n not in own])
    k2_stages = iter(zip(k2_program[::2], k2_program[1::2]))
    program: list[int] = []
    taps: list[int] = []
    offsets: dict[str, int] = {}
    for name in names:
        if name in _RANK3_OPS:
            program += [_RANK3_OPS[name], 0, 0]
        elif name in tblur.RANK_STAGES:
            size, rank = tblur.RANK_STAGES[name]
            program += [OP_RANK, rank, size]
        elif name in tblur.KERNEL_STAGES:
            spec = tblur.KERNEL_STAGES[name]
            if name not in offsets:
                offsets[name] = len(taps)
                taps += [spec["scale"], spec["off2"],
                         *(t for row in spec["flipped"] for t in row)]
            program += [OP_KERNEL, offsets[name], spec["size"]]
        else:
            program += [*next(k2_stages), 0]
    return program, tables, taps


@functools.lru_cache(maxsize=64)
def _device_program(names: tuple, device: torch.device, lut_bytes: tuple,
                    kernel_specs: tuple):
    """The chain's program (host ints, passed by value at launch), its LUTs
    as one ``(n_luts, 256)`` uint8 device tensor and its tap table as one
    int32 device tensor, built once per (chain, device, LUT and kernel
    contents), so no copy runs on a launch."""
    program, tables, taps = encode_program(names)
    prog = (ctypes.c_int * len(program))(*program)
    luts = torch.from_numpy(np.stack(tables)).to(device) if tables else None
    tap_table = torch.tensor(taps, dtype=torch.int32, device=device) if taps else None
    return prog, luts, tap_table


def device_program(names: tuple, device: torch.device):
    """:func:`encode_program`'s program, LUTs and tap table for ``names`` on
    ``device``, cached per chain, device and LUT and kernel contents."""
    lut_bytes = tuple(tblur.LUT_STAGES[nm].tobytes() for nm in names
                      if nm in tblur.LUT_STAGES)
    kernel_specs = tuple((s["scale"], s["off2"], s["flipped"]) for s in
                         (tblur.KERNEL_STAGES[nm] for nm in names
                          if nm in tblur.KERNEL_STAGES))
    return _device_program(names, device, lut_bytes, kernel_specs)


def rank_chain_planar_cuda(
    x: torch.Tensor,
    names: Sequence[str],
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused chain of any stages over planar ``(N, H, W)`` uint8, through K3.

    The same call as :func:`hipe_tpu_torch.ops.cuda_chain.filter_chain_planar_cuda`:
    every stage clamps at the edges of its own input; with ``h_pad`` the
    output is ``(N, H, W)``, without it ``(N, H - 2R, W)``, R the chain's
    total radius. ``out``, if given, must not share memory with ``x``;
    ``rows_per_block`` is K3's launch knob.
    """
    names, ho, rpb = cuda_chain.check_planar_call(x, names, h_pad, rows_per_block, out)
    if x.device.type == "cpu":
        y = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    n, h, w = x.shape
    prog, luts, taps = device_program(names, x.device)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = lib.hipe_rank_chain_planar_u8(
            x.data_ptr(), out.data_ptr(), n, h, w, ctypes.addressof(prog),
            len(names), None if luts is None else luts.data_ptr(),
            0 if luts is None else luts.shape[0],
            None if taps is None else taps.data_ptr(),
            0 if taps is None else taps.numel(), int(h_pad), rpb,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.hipe_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"rank_chain_planar_u8 launch failed for {(n, h, w)} {names} "
            f"h_pad={h_pad} rows_per_block={rpb}: {msg} (cudaError {rc})")
    rank_chain_planar_cuda.launches += 1
    return out


rank_chain_planar_cuda.launches = 0
