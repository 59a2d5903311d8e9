"""Integer-exact separable bilinear resize (``hipe_tpu.ops.resize`` in torch).

The contract is ``hipe_tpu``'s own:

- half-pixel source mapping (``align_corners=False``):
  ``src = (dst + 0.5) * in / out - 0.5``, clamped to ``[0, in - 1]``;
- weights in Q14 fixed point: ``wr = round(frac * 2^14)``, ``wl = 2^14 - wr``;
- each axis pass computes ``(wl * x[lo] + wr * x[hi] + 2^13) >> 14``, the W
  pass first and then the H pass, quantized to uint8 between the two.

``hipe_tpu`` computes each pass as an fp32 banded matmul, exact because the
two-tap sums stay below 2^23. On the card an fp32 matmul is exact only while
TF32 is off, and there is no int32 matmul, so here each pass gathers its two
taps and sums them in int32: the same integers on every device, and no
(in x out) band matrix. Plain XLA ops in ``hipe_tpu``, torch ops here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_Q = 14
_HALF = 1 << (_Q - 1)
# Output elements a chunk of a pass (its int32 temporaries: 4 bytes each).
CHUNK_ELEMENTS = 1 << 26


@functools.lru_cache(maxsize=256)
def _taps(n_in: int, n_out: int) -> tuple[np.ndarray, ...]:
    """(lo, hi, wl, wr) int64 for each output index: the two source taps
    and their Q14 weights (``hipe_tpu``'s ``_band_np`` entries)."""
    j = np.arange(n_out, dtype=np.float64)
    src = np.clip((j + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    wr = np.rint((src - lo) * (1 << _Q)).astype(np.int64)
    return lo, hi, (1 << _Q) - wr, wr


def _pass(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """One axis pass of uint8 ``x`` along ``dim`` (< 0) to ``n_out``."""
    lo, hi, wl, wr = (torch.from_numpy(a).to(x.device)
                      for a in _taps(x.shape[dim], n_out))
    shape = [1] * (-dim)
    shape[0] = n_out
    wl, wr = wl.to(torch.int32).view(shape), wr.to(torch.int32).view(shape)
    flat = x.reshape(-1, *x.shape[x.dim() + dim:])
    out = torch.empty((flat.shape[0], n_out, *flat.shape[2:]), dtype=torch.uint8,
                      device=x.device)
    per = max(1, CHUNK_ELEMENTS // max(1, out[0].numel()))
    for i in range(0, flat.shape[0], per):
        xi = flat[i:i + per].to(torch.int32)
        acc = xi.index_select(1, lo) * wl + xi.index_select(1, hi) * wr
        out[i:i + per] = (acc + _HALF) >> _Q
    return out.reshape(*x.shape[:x.dim() + dim], n_out, *x.shape[x.dim() + dim + 1:])


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize (..., H, W, C) uint8 to (..., out_h, out_w, C) (the module's
    contract), on ``x``'s device."""
    if x.dtype != torch.uint8 or x.dim() < 3:
        raise ValueError(f"expected (..., H, W, C) uint8, got {x.dtype} {tuple(x.shape)}")
    h, w = x.shape[-3], x.shape[-2]
    if w != out_w:
        x = _pass(x, -2, out_w)
    if h != out_h:
        x = _pass(x, -3, out_h)
    return x


def resize_bilinear_planar(planes: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Planar (N, H, W) uint8 variant (one plane an image channel)."""
    if planes.dtype != torch.uint8 or planes.dim() != 3:
        raise ValueError(f"expected (N, H, W) uint8, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    h, w = planes.shape[-2:]
    if w != out_w:
        planes = _pass(planes, -1, out_w)
    if h != out_h:
        planes = _pass(planes, -2, out_h)
    return planes
