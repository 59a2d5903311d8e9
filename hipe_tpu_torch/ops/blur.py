"""Integer-exact image filters in plain PyTorch (counterpart of ``hipe_tpu.ops.blur``).

These are the plain tensor versions of the band and point stages: uint8 in,
int32 arithmetic, uint8 out, clamp-to-edge borders. They are what the CUDA
kernels (:mod:`hipe_tpu_torch.ops.cuda_blur`, :mod:`hipe_tpu_torch.ops.cuda_chain`)
are held against, and what their wrappers run for a tensor that lies on the
CPU. They work on any layout where H and W are identifiable axes (NHWC, HWC,
planar ``(N, H, W)``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from hipe_tpu_torch.ops.reference import binomial_taps as _np_binomial_taps


def binomial_taps(radius: int) -> tuple[tuple[int, ...], int]:
    """Integer binomial taps and per-axis shift (see ops.reference)."""
    taps, shift = _np_binomial_taps(radius)
    return tuple(int(t) for t in taps), shift


def _edge_pad_axis(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Pad ``x`` by ``r`` along ``axis`` by replicating the edge slices."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = r
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=axis)


def _conv1d(x: torch.Tensor, axis: int, taps: Sequence[int], pad: bool) -> torch.Tensor:
    """1-D integer correlation along ``axis``.

    With ``pad=True`` the borders clamp to the edge (output length == input
    length); with ``pad=False`` only the valid interior is computed (output
    length == input - 2*radius), for inputs that carry their halo rows.
    """
    r = (len(taps) - 1) // 2
    xp = _edge_pad_axis(x, axis, r) if pad else x
    n = xp.shape[axis] - 2 * r
    if n < 1:
        raise ValueError(
            f"valid mode needs more than {2 * r} entries along axis {axis}, "
            f"got {xp.shape[axis]}"
        )
    acc = None
    for j, t in enumerate(taps):
        sl = xp.narrow(axis, j, n)
        term = sl if t == 1 else sl * t
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur(
    x: torch.Tensor,
    radius: int = 1,
    *,
    h_axis: int = -3,
    w_axis: int = -2,
    h_pad: bool = True,
) -> torch.Tensor:
    """Separable binomial Gaussian blur, integer-exact.

    radius=1 is the reference 3x3 kernel (``gaussian_kernel.cl:36-41,70``);
    radius 2-4 are the 5x5/7x7/9x9 separable variants. Default axes assume
    channels-last layouts (..., H, W, C). W always clamps at its edges; H
    clamps only with ``h_pad`` — ``h_pad=False`` treats H as carrying
    ``radius`` halo rows per side and returns ``H - 2*radius`` rows.
    """
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    taps, shift = binomial_taps(radius)
    acc = x.to(torch.int32)
    acc = _conv1d(acc, w_axis % x.dim(), taps, pad=True)
    acc = _conv1d(acc, h_axis % x.dim(), taps, pad=h_pad)
    return (acc >> (2 * shift)).to(torch.uint8)


def gaussian_blur3x3(x: torch.Tensor, **kw) -> torch.Tensor:
    """The reference kernel: 3x3 binomial blur (``gaussian_kernel.cl:19-72``)."""
    return gaussian_blur(x, radius=1, **kw)


def gaussian_blur_planar(x: torch.Tensor, radius: int = 1, *,
                         h_pad: bool = True) -> torch.Tensor:
    """Blur for planar layouts (..., H, W) — one plane per (image, channel)."""
    return gaussian_blur(x, radius, h_axis=-2, w_axis=-1, h_pad=h_pad)


def _stencil3x3(x: torch.Tensor, h_axis: int, w_axis: int, h_pad: bool):
    """Return ``view(dy, dx)``: the 9 int32 shifted views of x for a 3x3 stencil.

    W clamps at its edges; H clamps with ``h_pad`` and is valid-only (one
    row fewer at each end) without it.
    """
    h_axis %= x.dim()
    w_axis %= x.dim()
    xp = _edge_pad_axis(x.to(torch.int32), w_axis, 1)
    if h_pad:
        xp = _edge_pad_axis(xp, h_axis, 1)
    hn = xp.shape[h_axis] - 2
    wn = xp.shape[w_axis] - 2
    if hn < 1:
        raise ValueError(
            f"valid mode needs more than 2 entries along axis {h_axis}, "
            f"got {xp.shape[h_axis]}")

    def view(dy: int, dx: int) -> torch.Tensor:
        return xp.narrow(h_axis, dy, hn).narrow(w_axis, dx, wn)

    return view


def sharpen3x3(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
               h_pad: bool = True) -> torch.Tensor:
    """Unsharp 3x3 [[0,-1,0],[-1,5,-1],[0,-1,0]], saturating uint8 store."""
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    v = _stencil3x3(x, h_axis, w_axis, h_pad)
    out = 5 * v(1, 1) - v(0, 1) - v(2, 1) - v(1, 0) - v(1, 2)
    return out.clamp(0, 255).to(torch.uint8)


def sobel_edge(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
               h_pad: bool = True) -> torch.Tensor:
    """Sobel |gx|+|gy| edge magnitude, per channel, saturating uint8 store."""
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    v = _stencil3x3(x, h_axis, w_axis, h_pad)
    gx = (v(0, 2) + 2 * v(1, 2) + v(2, 2)) - (v(0, 0) + 2 * v(1, 0) + v(2, 0))
    gy = (v(2, 0) + 2 * v(2, 1) + v(2, 2)) - (v(0, 0) + 2 * v(0, 1) + v(0, 2))
    return (gx.abs() + gy.abs()).clamp(0, 255).to(torch.uint8)


# ---- Radius-0 point stages (the PIL ImageOps pointwise family) ----
#   invert:     255 - x
#   solarize:   x if x < 128 else 255 - x   (PIL default threshold)
#   posterizeB: x & (0x100 - (1 << (8 - B)))  (PIL posterize(bits=B))


def posterize_mask(bits: int) -> int:
    """PIL's posterize mask: 0x80 at 1 bit, 0xF0 at 4, 0xFF at 8."""
    return 0x100 - (1 << (8 - bits))


def _posterize(bits: int):
    mask = posterize_mask(bits)
    return lambda x: x & mask


# Stage name -> int32 -> int32 function (values stay in [0, 255]).
POINT_STAGES = {
    "invert": lambda x: 255 - x,
    "solarize": lambda x: torch.where(x >= 128, 255 - x, x),
    **{f"posterize{b}": _posterize(b) for b in range(1, 9)},
}


def _make_point_filter(fn):
    def op(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
           h_pad: bool = True) -> torch.Tensor:
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        return fn(x.to(torch.int32)).to(torch.uint8)

    return op


GAUSSIANS = ("gaussian3", "gaussian5", "gaussian7", "gaussian9")

# Registry of named filter ops. Each maps uint8 -> uint8 and accepts
# (h_axis, w_axis, h_pad) kwargs; chains quantize to uint8 between stages.
FILTERS = {
    "gaussian3": gaussian_blur3x3,
    "gaussian5": functools.partial(gaussian_blur, radius=2),
    "gaussian7": functools.partial(gaussian_blur, radius=3),
    "gaussian9": functools.partial(gaussian_blur, radius=4),
    "sharpen": sharpen3x3,
    "edge": sobel_edge,
    **{nm: _make_point_filter(fn) for nm, fn in POINT_STAGES.items()},
}

# Halo rows each filter needs on each side of its H slice (== stencil radius).
FILTER_RADIUS = {
    "gaussian3": 1,
    "gaussian5": 2,
    "gaussian7": 3,
    "gaussian9": 4,
    "sharpen": 1,
    "edge": 1,
    **{nm: 0 for nm in POINT_STAGES},
}

# Builtin stages of hipe_tpu that this package does not carry yet (the rank
# family, registered-kernel presets); ROADMAP.md lists their order. Their
# names stay reserved: they are not free for register_lut_filter.
UNPORTED_STAGES = frozenset({
    "median", "erode", "dilate", "median5", "erode5", "dilate5", "median7",
    "median9", "pil_blur", "pil_contour", "pil_detail", "pil_edge_enhance",
    "pil_edge_enhance_more", "pil_emboss", "pil_find_edges", "pil_sharpen",
    "pil_smooth", "pil_smooth_more",
})


def filter_chain(x: torch.Tensor, names: Sequence[str], *, h_axis: int = -3,
                 w_axis: int = -2, h_pad: bool = True) -> torch.Tensor:
    """Apply named filters sequentially (uint8 quantization between stages).

    With ``h_pad=False`` the input must carry ``chain_radius(names)`` halo
    rows per side; each stage consumes its own radius, so the output is the
    valid interior.
    """
    for name in names:
        x = FILTERS[name](x, h_axis=h_axis, w_axis=w_axis, h_pad=h_pad)
    return x


def chain_radius(names: Sequence[str]) -> int:
    """Total halo each side needed to run a chain 'valid' over split rows."""
    return sum(FILTER_RADIUS[n] for n in names)


# ---- Static-LUT point stages (brightness / gamma / arbitrary 256-LUTs) ---
#
# Any 256-entry uint8 LUT registers as a radius-0 point stage. hipe_tpu
# applies it as a comparison sum (the TPU has no vector gather); here it is
# a gather, which the card does natively, with the same integer result.
# The constructors reproduce PIL exactly (see hipe_tpu.ops.blur).

LUT_STAGES: dict = {}


def _make_lut_point_fn(lut: np.ndarray):
    table = torch.from_numpy(lut.copy())

    def fn(x: torch.Tensor) -> torch.Tensor:
        return table.to(x.device)[x.long()].to(x.dtype)

    return fn


def register_lut_filter(name: str, lut) -> None:
    """Register a 256-entry uint8 LUT as a chainable radius-0 point stage.

    Re-registering the same name with an identical LUT is a no-op; a
    different LUT, or the name of a builtin stage, raises.
    """
    lut = np.asarray(lut)
    if lut.shape != (256,):
        raise ValueError(
            f"LUT {name!r}: expected 256 entries, got shape {lut.shape}")
    if lut.dtype != np.uint8:
        if not (np.issubdtype(lut.dtype, np.integer)
                and lut.min() >= 0 and lut.max() <= 255):
            raise ValueError(
                f"LUT {name!r}: entries must be integers in [0, 255]")
        lut = lut.astype(np.uint8)
    prev = LUT_STAGES.get(name)
    if prev is not None:
        if np.array_equal(prev, lut):
            return
        raise ValueError(f"LUT {name!r} already registered with "
                         "different entries")
    if name in FILTERS or name in UNPORTED_STAGES:
        raise ValueError(f"{name!r} is already a builtin filter name")
    LUT_STAGES[name] = lut
    fn = _make_lut_point_fn(lut)
    POINT_STAGES[name] = fn
    FILTERS[name] = _make_point_filter(fn)
    FILTER_RADIUS[name] = 0


def brightness_lut(factor: float) -> np.ndarray:
    """PIL ``ImageEnhance.Brightness(im).enhance(factor)`` as a LUT.

    PIL's Image.blend is fp32 ``a + f*(b-a)`` with a truncating uint8
    store, blending from black: ``lut[v] = clip(trunc(fp32(factor) * v))``.
    """
    if factor < 0:
        raise ValueError(f"brightness factor must be >= 0, got {factor}")
    v = np.arange(256, dtype=np.float32)
    out = np.trunc((np.float32(factor) * v).astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def solarize_lut(threshold: int = 128) -> np.ndarray:
    """PIL ``ImageOps.solarize(im, threshold)`` as a LUT: identity below the
    threshold, inverted at and above it."""
    if not 0 <= threshold <= 256:
        raise ValueError(f"threshold must be in [0, 256], got {threshold}")
    v = np.arange(256, dtype=np.int64)
    return np.where(v < threshold, v, 255 - v).astype(np.uint8)


def gamma_lut(gamma: float) -> np.ndarray:
    """Gamma-correction LUT: ``lut[v] = round(255 * (v/255)**gamma)``."""
    if gamma <= 0:
        raise ValueError(f"gamma must be > 0, got {gamma}")
    v = np.arange(256, dtype=np.float64) / 255.0
    return np.clip(np.round(255.0 * v ** gamma), 0, 255).astype(np.uint8)
