"""Large planes on the card: wrappers of kernels K4 (``csrc/tiled_blur_planar.cu``)
and K5 (``csrc/tiled_stage_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur``'s halo-tiled path for planes
too large for the fused kernels (``gaussian_blur_planar_tiled_pallas``,
``filter_chain_planar_tiled_pallas``): K4 stands for ``_tiled_blur_kernel``
and K5 for ``_tiled_point_kernel``. Both run one stage over 2-D tiles of
``tile = (TH, TW)`` output pixels, ``TW`` rounded up to a multiple of 8
inside the kernels (a run of 8 outputs a thread). Each block stages its
tile's padded window (``csrc/tiled_lanes.cuh``): the rows and columns the
stage reads, clamped at the true plane edges in both axes as they are
staged, so that no tap clamps.

:func:`filter_chain_planar_tiled_cuda` runs a chain stage by stage, as
``hipe_tpu`` does on this path: gaussian stages on K4, every other stage on
K5, each clamping at the true edges, the intermediates in at most two
buffers of the call's own. Valid mode (``h_pad=False``) is
clamp-then-trim: the last stage writes rows ``[R, H - R)``, R the chain's
total radius, which equals ``hipe_tpu``'s per-stage valid chain.

For a CUDA tensor each wrapper launches its kernels or raises; for a CPU
tensor it runs the plain PyTorch version (:mod:`hipe_tpu_torch.ops.blur`),
which is also what the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_chain import check_planar_call
from hipe_tpu_torch.ops.cuda_rank_chain import device_program

# Output tile (rows, columns) of one thread block when the caller names none;
# the runner's autotune sweeps the alternatives.
DEFAULT_TILE = (32, 256)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hipe_tiled_blur_planar_u8.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                              ci, vp]
    lib.hipe_tiled_blur_planar_u8.restype = ci
    lib.hipe_tiled_stage_planar_u8.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, vp,
                                               ci, vp, ci, ci, ci, ci, ci, vp]
    lib.hipe_tiled_stage_planar_u8.restype = ci
    lib.hipe_cuda_error_string.argtypes = [ci]
    lib.hipe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_tile(tile) -> tuple[int, int]:
    """``tile`` as ``(TH, TW)`` positive ints; ``None`` is :data:`DEFAULT_TILE`."""
    th, tw = DEFAULT_TILE if tile is None else (int(tile[0]), int(tile[1]))
    if th < 1 or tw < 1:
        raise ValueError(f"tile must be two positive ints (rows, columns), got {tile!r}")
    return th, tw


# Output bytes a thread of K2, K3, K4 or K5 computes at once (kRun in
# csrc/chain_lanes.cuh); K4's and K5's tile widths are rounded up to it.
RUN = 8


def window_pitch(tw: int) -> int:
    """Bytes of one row of a K4/K5 block's window for tiles ``tw`` wide
    (``window_pitch`` in ``csrc/tiled_lanes.cuh``): the tile's columns,
    ``tw`` rounded up to :data:`RUN`, and the 4 columns a run reads on each
    side, each end rounded out to 16 bytes. A tile starts at a multiple of
    8, so that is at most the rounded width, itself rounded up to 16, plus
    32 bytes."""
    cols = -(-tw // RUN) * RUN
    return (cols + 8 + 15) // 16 * 16 + 16


def shared_bytes(name: str, tile) -> int:
    """Shared memory of one block of the stage's kernel at ``tile``: ``TH``
    output rows and the stage's ``r`` halo rows on each side, each
    :func:`window_pitch` bytes (K4 and K5 alike)."""
    th, tw = check_tile(tile)
    return (th + 2 * tblur.FILTER_RADIUS[name]) * window_pitch(tw)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernel_lib().hipe_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: {msg} (cudaError {rc})")


def _launch_k4(x: torch.Tensor, radius: int, trim: int, ho: int, tile: tuple,
               out: torch.Tensor) -> None:
    n, h, w = x.shape
    with torch.cuda.device(x.device):
        rc = _kernel_lib().hipe_tiled_blur_planar_u8(
            x.data_ptr(), out.data_ptr(), n, h, w, radius, trim, ho, tile[0], tile[1],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, f"tiled_blur_planar_u8 launch failed for {(n, h, w)} r={radius} "
                  f"rows [{trim}, {trim + ho}) tile={tile}")
    gaussian_blur_planar_tiled_cuda.launches += 1


def _launch_k5(x: torch.Tensor, name: str, trim: int, ho: int, tile: tuple,
               out: torch.Tensor) -> None:
    n, h, w = x.shape
    prog, luts, taps = device_program((name,), x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_lib().hipe_tiled_stage_planar_u8(
            x.data_ptr(), out.data_ptr(), n, h, w, prog[0], prog[1], prog[2],
            None if luts is None else luts.data_ptr(),
            0 if luts is None else luts.shape[0],
            None if taps is None else taps.data_ptr(),
            0 if taps is None else taps.numel(), trim, ho, tile[0], tile[1],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, f"tiled_stage_planar_u8 launch failed for {(n, h, w)} {name} "
                  f"rows [{trim}, {trim + ho}) tile={tile}")
    filter_stage_planar_tiled_cuda.launches += 1


def gaussian_blur_planar_tiled_cuda(
    x: torch.Tensor,
    radius: int = 1,
    *,
    tile=None,
    h_pad: bool = True,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One binomial blur (radius 1-4) over planar ``(N, H, W)`` uint8 on K4.

    The counterpart of ``gaussian_blur_planar_tiled_pallas``. W clamps at
    its edges; H clamps with ``h_pad`` (output ``(N, H, W)``) and is
    valid-only without it (``(N, H - 2r, W)``). ``tile`` is K4's launch
    knob, ``(TH, TW)`` output pixels a block; ``out``, if given, must not
    share memory with ``x``.
    """
    if not 1 <= radius <= 4:
        raise ValueError(f"radius must be 1-4, got {radius}")
    _, ho, _ = check_planar_call(x, (tblur.GAUSSIANS[radius - 1],), h_pad, None, out)
    n, h, w = x.shape
    tile = check_tile(tile)
    if x.device.type == "cpu":
        y = tblur.gaussian_blur_planar(x, radius, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    _launch_k4(x, radius, 0 if h_pad else radius, ho, tile, out)
    return out


gaussian_blur_planar_tiled_cuda.launches = 0


def filter_stage_planar_tiled_cuda(
    x: torch.Tensor,
    name: str,
    *,
    tile=None,
    h_pad: bool = True,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One stage of any kind but gaussian over planar ``(N, H, W)`` uint8 on K5.

    The counterpart of one ``_tiled_point_kernel`` pass: sharpen, edge,
    median, erode, dilate, rank stages (size 3-9), registered kernel stages
    and point stages (LUTs included). ``h_pad``, ``tile`` and ``out`` as in
    :func:`gaussian_blur_planar_tiled_cuda`.
    """
    if name in tblur.GAUSSIANS:
        raise ValueError(f"{name} runs on K4: gaussian_blur_planar_tiled_cuda")
    _, ho, _ = check_planar_call(x, (name,), h_pad, None, out)
    n, h, w = x.shape
    tile = check_tile(tile)
    if x.device.type == "cpu":
        y = tblur.FILTERS[name](x, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    _launch_k5(x, name, (h - ho) // 2, ho, tile, out)
    return out


filter_stage_planar_tiled_cuda.launches = 0


def filter_chain_planar_tiled_cuda(
    x: torch.Tensor,
    names: Sequence[str],
    *,
    tile=None,
    h_pad: bool = True,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """A chain over planar ``(N, H, W)`` uint8, stage by stage on K4 and K5.

    The counterpart of ``filter_chain_planar_tiled_pallas``, with
    ``hipe_tpu``'s valid mode too: with ``h_pad`` the output is ``(N, H,
    W)``, without it ``(N, H - 2R, W)``, R the chain's total radius. Every
    stage clamps at the true edges of its own input. ``tile`` is the
    kernels' launch knob; ``out``, if given, must not share memory with
    ``x``. Intermediates alternate between at most two buffers of this
    call, taken from torch's caching allocator on the current stream: no
    other call or stream shares them, and in steady state they come from
    its cache, not from a device allocation.
    """
    names, ho, _ = check_planar_call(x, names, h_pad, None, out)
    n, h, w = x.shape
    tile = check_tile(tile)
    if x.device.type == "cpu":
        y = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    scratch = [torch.empty((n, h, w), dtype=torch.uint8, device=x.device)
               for _ in range(min(2, len(names) - 1))]
    src = x
    for k, name in enumerate(names):
        last = k == len(names) - 1
        dst = out if last else scratch[k % 2]
        trim, rows = ((h - ho) // 2, ho) if last else (0, h)
        if name in tblur.GAUSSIANS:
            _launch_k4(src, tblur.FILTER_RADIUS[name], trim, rows, tile, dst)
        else:
            _launch_k5(src, name, trim, rows, tile, dst)
        src = dst
    return out
