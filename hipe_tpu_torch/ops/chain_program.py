"""What the wrappers of K1-K5 share: the check of a planar call, and the
stage program K2, K3 and K5 read.

A chain's stages go to the kernels by value as a program of op codes (enum
Op in ``csrc/chain_stages.cuh``): K2 reads ``[op, arg]`` pairs of band and
point stages (:func:`encode_band_program`), K3 and K5 ``[op, arg, size]``
triples of every stage (:func:`encode_program`). LUT stages index one
``(n_luts, 256)`` uint8 table and kernel stages one int32 tap table, both on
the device (:func:`device_program`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from hipe_tpu_torch.ops import blur as tblur

# Output rows per thread block of K2 and K3 when the caller names none; the
# runner's autotune sweeps the alternatives.
DEFAULT_ROWS_PER_BLOCK = 32

# Stage op codes (enum Op in csrc/chain_stages.cuh): K2 takes 0-6, K3 every
# one, K5 every one but gaussian.
(OP_GAUSSIAN, OP_SHARPEN, OP_EDGE, OP_INVERT, OP_SOLARIZE, OP_POSTERIZE, OP_LUT,
 OP_MEDIAN, OP_ERODE, OP_DILATE, OP_RANK, OP_KERNEL) = range(12)
_FIXED_OPS = {"sharpen": OP_SHARPEN, "edge": OP_EDGE, "invert": OP_INVERT,
              "solarize": OP_SOLARIZE}
_RANK3_OPS = {"median": OP_MEDIAN, "erode": OP_ERODE, "dilate": OP_DILATE}


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
    W*C)``) for K1-K5.

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


def encode_band_program(names: Sequence[str]) -> tuple[list[int], list[np.ndarray]]:
    """K2's stage program for a band chain: ``[op0, arg0, op1, arg1, ...]``,
    and the LUT tables its ``lut`` stages index, in order of first use."""
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


def encode_program(names: Sequence[str]) -> tuple[list[int], list[np.ndarray], list[int]]:
    """K3's and K5's stage program ``[op0, arg0, size0, ...]``, the LUT
    tables its ``lut`` stages index, and its tap table.

    Band and point stages take K2's op codes and arguments with size 0. A
    rank stage is ``(OP_RANK, rank, size)``; median, erode and dilate are
    ``(op, 0, 0)``. A kernel stage is ``(OP_KERNEL, offset, size)``, where
    its spec ``[scale, off2, flipped taps row-major]`` starts at ``offset``
    of the tap table; each kernel's spec is stored once, in order of first
    use, and so is each LUT.
    """
    own = {n for n in names
           if n in _RANK3_OPS or n in tblur.RANK_STAGES or n in tblur.KERNEL_STAGES}
    band_program, tables = encode_band_program([n for n in names if n not in own])
    band_stages = iter(zip(band_program[::2], band_program[1::2]))
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
            program += [*next(band_stages), 0]
    return program, tables, taps


@functools.lru_cache(maxsize=64)
def _device_program(names: tuple, device: torch.device, band: bool, lut_bytes: tuple,
                    kernel_specs: tuple):
    if band:
        (program, tables), taps = encode_band_program(names), []
    else:
        program, tables, taps = encode_program(names)
    prog = (ctypes.c_int * len(program))(*program)
    luts = torch.from_numpy(np.stack(tables)).to(device) if tables else None
    tap_table = torch.tensor(taps, dtype=torch.int32, device=device) if taps else None
    return prog, luts, tap_table


def device_program(names: tuple, device: torch.device, *, band: bool = False):
    """The chain's program (host ints, passed by value at launch; K2's pairs
    with ``band``, else K3's and K5's triples), its LUTs as one ``(n_luts,
    256)`` uint8 device tensor and its tap table as one int32 device tensor,
    built once per chain, device and LUT and kernel contents, so no copy
    runs on a launch."""
    lut_bytes = tuple(tblur.LUT_STAGES[nm].tobytes() for nm in names
                      if nm in tblur.LUT_STAGES)
    kernel_specs = tuple((s["scale"], s["off2"], s["flipped"]) for s in
                         (tblur.KERNEL_STAGES[nm] for nm in names
                          if nm in tblur.KERNEL_STAGES))
    return _device_program(names, device, band, lut_bytes, kernel_specs)


def table_args(t: torch.Tensor | None) -> tuple:
    """A device table as a launch's (pointer, entries) pair; ``(None, 0)`` for none."""
    return (None, 0) if t is None else (t.data_ptr(), t.shape[0])
