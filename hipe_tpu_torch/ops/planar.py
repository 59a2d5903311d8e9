"""The one place that chooses the kernel of a chain over planar ``(N, H, W)``
uint8, and the shared-memory reckoning that choice needs.

A single gaussian runs K1 (:mod:`~hipe_tpu_torch.ops.cuda_blur`), which
keeps its row sums in registers and takes planes of any width (at 4000x2250
it runs faster than K4; PERF.md). Every other band and point chain runs
the fused chain kernel K2 (:mod:`~hipe_tpu_torch.ops.cuda_chain`), and
every chain with a rank or registered-kernel stage runs K3
(:mod:`~hipe_tpu_torch.ops.cuda_rank_chain`), as ``hipe_tpu`` routes them to
its blur kernel, ``_chain_mxu_kernel`` and ``_chain_kernel``. A plane too
wide for K2's or K3's shared memory (:func:`routes_tiled`, e.g. the
reference's 4000x2250 frames) runs stage by stage on the tiled kernels K4
(gaussian) and K5 (every other stage; :mod:`~hipe_tpu_torch.ops.cuda_tiled`),
as ``hipe_tpu`` sends oversized planes to ``_tiled_blur_kernel`` and
``_tiled_point_kernel``. Both routes give the same integers.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.chain_program import is_band_chain
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
from hipe_tpu_torch.ops.cuda_tiled import check_tile, filter_chain_planar_tiled_cuda

# Shared memory a thread block may take on an H100 (227 KB, opted in above
# the default 48 KB), and the tile height a fused kernel must be able to
# stage within it for a plane to stay on K1, K2 or K3. The threshold
# replaces hipe_tpu's WHOLE_PLANE_PIXEL_LIMIT, which is sized to a TPU's VMEM.
SHARED_BYTES_PER_BLOCK = 232_448
ROUTE_TILE_ROWS = 32
# Output bytes a thread of K2, K3, K4 or K5 computes at once (kRun in
# csrc/chain_lanes.cuh); K4's and K5's tile widths are rounded up to it.
RUN = 8
# The launch knob of K1, K2 and K3 swept by the runner's autotune: output
# rows per block, plus one block per whole plane (from the plane height).
ROWS_PER_BLOCK_CANDIDATES = (8, 16, 32, 64, 128)
# The launch knob of K4 and K5 on the tiled route: output tile rows x
# columns; a shape whose block would exceed shared memory is skipped.
TILE_ROWS_CANDIDATES = (8, 16, 32, 64)
TILE_COLS_CANDIDATES = (128, 256, 512)


def lane_pitch(w: int) -> int:
    """Bytes of one padded row of K2's and K3's stage buffers for planes
    ``w`` wide (``lane_pitch`` in ``csrc/chain_lanes.cuh``): 16 lead bytes,
    the row, pads to column ``round_up(w, RUN) + 3``, rounded up to 16."""
    return (-(-w // RUN) * RUN + 20 + 15) & ~15


def fused_shared_bytes(rows: int, w: int, names) -> int:
    """Shared memory of one block of the fused kernel that takes ``names``
    for a tile of ``rows`` planar rows of ``w`` bytes and its halo: none
    for a single gaussian (K1 keeps its row sums in registers, at any
    width and ``rows_per_block``); else K2's and K3's two padded uint8
    buffers of :func:`lane_pitch` bytes a row and 256 bytes for each
    distinct LUT stage."""
    if len(names) == 1 and names[0] in tblur.GAUSSIANS:
        return 0
    r = tblur.chain_radius(names)
    luts = len({nm for nm in names if nm in tblur.LUT_STAGES})
    return 2 * (rows + 2 * r) * lane_pitch(w) + 256 * luts


def window_pitch(tw: int) -> int:
    """Bytes of one row of a K4/K5 block's window for tiles ``tw`` wide
    (``window_pitch`` in ``csrc/tiled_lanes.cuh``): the tile's columns,
    ``tw`` rounded up to :data:`RUN`, and the 4 columns a run reads on each
    side, each end rounded out to 16 bytes. A tile starts at a multiple of
    8, so that is at most the rounded width, itself rounded up to 16, plus
    32 bytes."""
    cols = -(-tw // RUN) * RUN
    return (cols + 8 + 15) // 16 * 16 + 16


def tiled_shared_bytes(name: str, tile) -> int:
    """Shared memory of one block of the stage's tiled kernel (K4 or K5) at
    ``tile``: ``TH`` output rows and the stage's ``r`` halo rows on each
    side, each :func:`window_pitch` bytes."""
    th, tw = check_tile(tile)
    return (th + 2 * tblur.FILTER_RADIUS[name]) * window_pitch(tw)


def routes_tiled(h: int, w: int, names) -> bool:
    """Whether (h, w) planes of the chain go to the tiled kernels K4/K5: the
    fused kernel cannot stage a :data:`ROUTE_TILE_ROWS`-row tile (or the
    whole plane, if shorter) plus its halo in :data:`SHARED_BYTES_PER_BLOCK`."""
    return fused_shared_bytes(min(ROUTE_TILE_ROWS, h), w, names) > SHARED_BYTES_PER_BLOCK


def launch_candidates(h: int, w: int, names) -> list[tuple[str, dict, str | None]]:
    """(label, launch config, reason to skip or None) for each value of the
    knob of the route (h, w) planes of the chain take: ``rows_per_block``
    of K1/K2/K3 (``cuda_rpb<n>``, small bands, then whole planes) or K4's
    and K5's ``tile`` (``cuda_tile<rows>x<cols>``)."""
    if not routes_tiled(h, w, names):
        return [(f"cuda_rpb{rpb}", {"rows_per_block": rpb}, None)
                for rpb in sorted({min(k, h) for k in ROWS_PER_BLOCK_CANDIDATES} | {h})]
    out = []
    for tile in ((th, tw) for th in TILE_ROWS_CANDIDATES for tw in TILE_COLS_CANDIDATES):
        need = max(tiled_shared_bytes(nm, tile) for nm in names)
        why = (None if need <= SHARED_BYTES_PER_BLOCK else
               f"needs {need} B of shared memory a block, over {SHARED_BYTES_PER_BLOCK}")
        out.append((f"cuda_tile{tile[0]}x{tile[1]}", {"tile": tile}, why))
    return out


def filter_planar(planes: torch.Tensor, names: Sequence[str], *, h_pad: bool = True,
                  rows_per_block: int | None = None, tile=None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The chain ``names`` over planar ``(N, H, W)`` uint8 on its kernel: K1,
    K2 or K3, or K4 and K5 for planes too wide for them; each runs its
    plain version on the CPU.

    ``h_pad=False`` treats H as halo-padded by the chain's radius per side
    and returns the valid interior, on either route. ``rows_per_block`` is
    the fused kernels' launch knob, ``tile`` the tiled kernels'.
    """
    if routes_tiled(planes.shape[-2], planes.shape[-1], names):
        return filter_chain_planar_tiled_cuda(planes, names, tile=tile, h_pad=h_pad, out=out)
    if len(names) == 1 and names[0] in tblur.GAUSSIANS:
        return gaussian_blur_planar_cuda(planes, tblur.FILTER_RADIUS[names[0]], h_pad=h_pad,
                                         rows_per_block=rows_per_block, out=out)
    route = filter_chain_planar_cuda if is_band_chain(names) else rank_chain_planar_cuda
    return route(planes, names, h_pad=h_pad, rows_per_block=rows_per_block, out=out)
