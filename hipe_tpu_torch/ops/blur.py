"""Integer-exact image filters in plain PyTorch (counterpart of ``hipe_tpu.ops.blur``).

These are the plain tensor versions of every stage: the band, point, rank
(median, erode, dilate, registered ``RankFilter``) and registered-kernel
(``ImageFilter.Kernel``, the ``pil_*`` presets) stages. uint8 in, exact
integer arithmetic, uint8 out, clamp-to-edge borders. They are what the CUDA
kernels (:mod:`hipe_tpu_torch.ops.cuda_blur`, :mod:`hipe_tpu_torch.ops.cuda_chain`,
:mod:`hipe_tpu_torch.ops.cuda_rank_chain`, :mod:`hipe_tpu_torch.ops.cuda_tiled`)
are held against, and what their wrappers run for a tensor that lies on the
CPU. They work on any layout where H and W are identifiable axes (NHWC, HWC,
planar ``(N, H, W)``); the ``*_rows`` ops and ``ROWS_FILTERS`` take
interleaved rows ``(..., H, W*C)`` and clamp a whole pixel at the edges.
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


def _stencil_r(x: torch.Tensor, h_axis: int, w_axis: int, h_pad: bool, r: int,
               dtype: torch.dtype = torch.int32):
    """Return ``view(dy, dx)``: the shifted views of x for a (2r+1)^2 stencil.

    The views are of ``dtype`` (int32 for stencils that sum; the rank
    family keeps uint8, since min, max and comparisons are exact on it).
    W clamps at its edges; H clamps with ``h_pad`` and is valid-only (r rows
    fewer at each end) without it.
    """
    h_axis %= x.dim()
    w_axis %= x.dim()
    xp = _edge_pad_axis(x.to(dtype), w_axis, r)
    if h_pad:
        xp = _edge_pad_axis(xp, h_axis, r)
    hn = xp.shape[h_axis] - 2 * r
    wn = xp.shape[w_axis] - 2 * r
    if hn < 1:
        raise ValueError(
            f"valid mode needs more than {2 * r} entries along axis {h_axis}, "
            f"got {xp.shape[h_axis]}")

    def view(dy: int, dx: int) -> torch.Tensor:
        return xp.narrow(h_axis, dy, hn).narrow(w_axis, dx, wn)

    return view


def sharpen3x3(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
               h_pad: bool = True) -> torch.Tensor:
    """Unsharp 3x3 [[0,-1,0],[-1,5,-1],[0,-1,0]], saturating uint8 store."""
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    v = _stencil_r(x, h_axis, w_axis, h_pad, 1)
    out = 5 * v(1, 1) - v(0, 1) - v(2, 1) - v(1, 0) - v(1, 2)
    return out.clamp(0, 255).to(torch.uint8)


def sobel_edge(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
               h_pad: bool = True) -> torch.Tensor:
    """Sobel |gx|+|gy| edge magnitude, per channel, saturating uint8 store."""
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    v = _stencil_r(x, h_axis, w_axis, h_pad, 1)
    gx = (v(0, 2) + 2 * v(1, 2) + v(2, 2)) - (v(0, 0) + 2 * v(1, 0) + v(2, 0))
    gy = (v(2, 0) + 2 * v(2, 1) + v(2, 2)) - (v(0, 0) + 2 * v(0, 1) + v(0, 2))
    return (gx.abs() + gy.abs()).clamp(0, 255).to(torch.uint8)


def _median_of_9(vals):
    """Elementwise median of 9 tensors: Paeth's 19-op min/max network.

    Sort each triple to (lo, me, hi); the median of all nine is then
    med3(max of the los, med3 of the mes, min of the his).
    """
    mn, mx = torch.minimum, torch.maximum

    def sort3(a, b, c):
        tl, th = mn(a, b), mx(a, b)
        return mn(tl, c), mx(tl, mn(th, c)), mx(th, c)

    def med3(a, b, c):
        return mx(mn(a, b), mn(mx(a, b), c))

    t = [sort3(*vals[i:i + 3]) for i in (0, 3, 6)]
    lo = mx(mx(t[0][0], t[1][0]), t[2][0])
    me = med3(t[0][1], t[1][1], t[2][1])
    hi = mn(mn(t[0][2], t[1][2]), t[2][2])
    return med3(lo, me, hi)


def median3x3(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
              h_pad: bool = True) -> torch.Tensor:
    """3x3 median (salt-and-pepper denoise), clamp-to-edge, per channel."""
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    v = _stencil_r(x, h_axis, w_axis, h_pad, 1, dtype=torch.uint8)
    return _median_of_9([v(dy, dx) for dy in range(3) for dx in range(3)])


def _rank3x3(x, h_axis, w_axis, h_pad, reduce_fn):
    """Separable 3x3 rank extreme: reduce W triples, then H triples."""
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    v = _stencil_r(x, h_axis, w_axis, h_pad, 1, dtype=torch.uint8)
    rows = [reduce_fn(reduce_fn(v(dy, 0), v(dy, 1)), v(dy, 2)) for dy in range(3)]
    return reduce_fn(reduce_fn(rows[0], rows[1]), rows[2])


def erode3x3(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
             h_pad: bool = True) -> torch.Tensor:
    """3x3 minimum (morphological erosion), PIL ``MinFilter(3)``."""
    return _rank3x3(x, h_axis, w_axis, h_pad, torch.minimum)


def dilate3x3(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
              h_pad: bool = True) -> torch.Tensor:
    """3x3 maximum (morphological dilation), PIL ``MaxFilter(3)``."""
    return _rank3x3(x, h_axis, w_axis, h_pad, torch.maximum)


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
    "median": median3x3,
    "erode": erode3x3,
    "dilate": dilate3x3,
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
    "median": 1,
    "erode": 1,
    "dilate": 1,
    **{nm: 0 for nm in POINT_STAGES},
}

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


# ---- Interleaved-rows layout (..., H, W*C) ----
#
# Each image row is one W*C vector of interleaved channels (a free reshape of
# channels-last data, the reference's device buffer layout). The W-axis
# stencil becomes a stencil with pixel stride C along the last axis, and the
# edge clamp replicates a whole pixel, a block of C lanes.


def _edge_pad_rows(x: torch.Tensor, axis: int, r: int, c: int) -> torch.Tensor:
    """Clamp-to-edge pad by r *pixels* (blocks of c lanes) along ``axis``."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, c)
    last = x.narrow(axis, n - c, c)
    reps = [1] * x.dim()
    reps[axis] = r
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=axis)


def _conv1d_rows(x: torch.Tensor, axis: int, taps: Sequence[int], c: int,
                 pad: bool) -> torch.Tensor:
    """1-D integer correlation with pixel stride c along ``axis``."""
    r = (len(taps) - 1) // 2
    xp = _edge_pad_rows(x, axis, r, c) if pad else x
    n = xp.shape[axis] - 2 * r * c
    acc = None
    for j, t in enumerate(taps):
        sl = xp.narrow(axis, j * c, n)
        term = sl if t == 1 else sl * t
        acc = term if acc is None else acc + term
    return acc


def _rows_stencil(x: torch.Tensor, c: int, h_pad: bool, r: int = 1,
                  dtype: torch.dtype = torch.int32):
    """``view(dy, dx)``, dy in [0, 2r] and dx in [-r, r]: the shifted views of
    ``(..., H, W*C)`` rows for a (2r+1)^2 stencil, clamped per pixel.

    H clamps with ``h_pad`` and is valid-only (r rows fewer at each end)
    without it, as in :func:`_stencil_r`.
    """
    xp = _edge_pad_rows(x.to(dtype), x.dim() - 1, r, c)
    if h_pad:
        xp = _edge_pad_axis(xp, x.dim() - 2, r)
    hn = xp.shape[-2] - 2 * r
    wn = xp.shape[-1] - 2 * r * c
    if hn < 1:
        raise ValueError(f"valid mode needs more than {2 * r} rows, got {xp.shape[-2]}")

    def view(dy: int, dx: int) -> torch.Tensor:
        return xp.narrow(-2, dy, hn).narrow(-1, (dx + r) * c, wn)

    return view


def _check_rows(x: torch.Tensor, channels: int) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    if channels < 1 or x.shape[-1] % channels:
        raise ValueError(f"row length {x.shape[-1]} is not a multiple of "
                         f"{channels} channels")


def gaussian_blur_rows(x: torch.Tensor, channels: int, radius: int = 1, *,
                       h_pad: bool = True) -> torch.Tensor:
    """Separable binomial blur on interleaved rows ``(..., H, W*C)``, exact."""
    _check_rows(x, channels)
    taps, shift = binomial_taps(radius)
    acc = _conv1d_rows(x.to(torch.int32), x.dim() - 1, taps, channels, pad=True)
    acc = _conv1d(acc, x.dim() - 2, taps, pad=h_pad)
    return (acc >> (2 * shift)).to(torch.uint8)


def sharpen3x3_rows(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
    _check_rows(x, channels)
    v = _rows_stencil(x, channels, h_pad)
    out = 5 * v(1, 0) - v(0, 0) - v(2, 0) - v(1, -1) - v(1, 1)
    return out.clamp(0, 255).to(torch.uint8)


def sobel_edge_rows(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
    _check_rows(x, channels)
    v = _rows_stencil(x, channels, h_pad)
    gx = (v(0, 1) + 2 * v(1, 1) + v(2, 1)) - (v(0, -1) + 2 * v(1, -1) + v(2, -1))
    gy = (v(2, -1) + 2 * v(2, 0) + v(2, 1)) - (v(0, -1) + 2 * v(0, 0) + v(0, 1))
    return (gx.abs() + gy.abs()).clamp(0, 255).to(torch.uint8)


def median3x3_rows(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
    _check_rows(x, channels)
    v = _rows_stencil(x, channels, h_pad, dtype=torch.uint8)
    return _median_of_9([v(dy, dx) for dy in range(3) for dx in (-1, 0, 1)])


def _rank3x3_rows(x, channels, h_pad, reduce_fn):
    _check_rows(x, channels)
    v = _rows_stencil(x, channels, h_pad, dtype=torch.uint8)
    rows = [reduce_fn(reduce_fn(v(dy, -1), v(dy, 0)), v(dy, 1)) for dy in range(3)]
    return reduce_fn(reduce_fn(rows[0], rows[1]), rows[2])


def erode3x3_rows(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
    return _rank3x3_rows(x, channels, h_pad, torch.minimum)


def dilate3x3_rows(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
    return _rank3x3_rows(x, channels, h_pad, torch.maximum)


def _make_point_filter_rows(fn):
    def op(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
        _check_rows(x, channels)
        return fn(x.to(torch.int32)).to(torch.uint8)

    return op


# Registry of the rows-layout ops: name -> op(x, channels, *, h_pad). The
# registries below (LUTs, kernels, ranks) fill it beside FILTERS.
ROWS_FILTERS = {
    "gaussian3": functools.partial(gaussian_blur_rows, radius=1),
    "gaussian5": functools.partial(gaussian_blur_rows, radius=2),
    "gaussian7": functools.partial(gaussian_blur_rows, radius=3),
    "gaussian9": functools.partial(gaussian_blur_rows, radius=4),
    "sharpen": sharpen3x3_rows,
    "edge": sobel_edge_rows,
    "median": median3x3_rows,
    "erode": erode3x3_rows,
    "dilate": dilate3x3_rows,
    **{nm: _make_point_filter_rows(fn) for nm, fn in POINT_STAGES.items()},
}


def filter_chain_rows(x: torch.Tensor, channels: int, names: Sequence[str], *,
                      h_pad: bool = True) -> torch.Tensor:
    """Filter chain on interleaved rows ``(..., H, W*C)``; ``h_pad`` as in
    :func:`filter_chain`."""
    for name in names:
        x = ROWS_FILTERS[name](x, channels, h_pad=h_pad)
    return x


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
    if name in FILTERS:
        raise ValueError(f"{name!r} is already a builtin filter name")
    LUT_STAGES[name] = lut
    fn = _make_lut_point_fn(lut)
    POINT_STAGES[name] = fn
    FILTERS[name] = _make_point_filter(fn)
    ROWS_FILTERS[name] = _make_point_filter_rows(fn)
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


# ---- User-defined convolution kernels (the PIL ImageFilter.Kernel family) --
#
# A registered kernel stage is an integer-tap correlation with an integer
# divisor and half-integer offset, rounded half up with exact integers:
#
#   out = clamp( (2*acc + scale*(2*offset + 1)) // (2*scale) )
#
# Taps are given in PIL orientation (row 0 first); PIL applies kernel rows
# bottom-up, so registration flips the rows (not the columns) into a
# top-down correlation. hipe_tpu divides by an fp32 reciprocal with a
# remainder correction because the TPU has no integer divide; here the
# floor division is exact integer division, with the same results.

KERNEL_STAGES: dict = {}

# hipe_tpu's bound on |2*acc + scale*(2*off+1)|; kept so that the same
# specs register in both packages (it also keeps every numerator in int32).
_KERNEL_NUM_LIMIT = 1 << 22


def _kernel_acc(view, flipped, size):
    acc = None
    for dy in range(size):
        for dx in range(size):
            t = flipped[dy][dx]
            if t == 0:
                continue
            term = view(dy, dx) if t == 1 else t * view(dy, dx)
            acc = term if acc is None else acc + term
    return acc if acc is not None else 0 * view(size // 2, size // 2)


def _make_kernel_stage(spec):
    size, flipped = spec["size"], spec["flipped"]
    den, cnum = 2 * spec["scale"], spec["scale"] * (spec["off2"] + 1)

    def op(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
           h_pad: bool = True) -> torch.Tensor:
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        v = _stencil_r(x, h_axis, w_axis, h_pad, size // 2)
        num = 2 * _kernel_acc(v, flipped, size) + cnum
        q = torch.div(num, den, rounding_mode="floor")
        return q.clamp(0, 255).to(torch.uint8)

    return op


def _make_kernel_stage_rows(spec):
    size, flipped = spec["size"], spec["flipped"]
    den, cnum = 2 * spec["scale"], spec["scale"] * (spec["off2"] + 1)
    r = size // 2

    def op(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
        _check_rows(x, channels)
        v = _rows_stencil(x, channels, h_pad, r)
        num = 2 * _kernel_acc(lambda dy, dx: v(dy, dx - r), flipped, size) + cnum
        q = torch.div(num, den, rounding_mode="floor")
        return q.clamp(0, 255).to(torch.uint8)

    return op


def register_kernel_filter(name: str, taps, scale: int | None = None,
                           offset: float = 0.0) -> None:
    """Register a user convolution kernel as a chainable filter stage.

    ``taps``: (2r+1)^2 integers in PIL ``ImageFilter.Kernel`` order (row 0
    first). ``scale`` defaults to ``sum(taps)`` and must be a positive
    integer; ``offset`` must be a multiple of 0.5. Re-registering the same
    name with an identical spec is a no-op; a conflicting spec, or the name
    of a builtin stage, raises.
    """
    taps = tuple(int(t) for t in taps)
    size = int(round(len(taps) ** 0.5))
    if size * size != len(taps) or size % 2 == 0 or not (3 <= size <= 9):
        raise ValueError(
            f"kernel {name!r}: taps must be a full odd square "
            f"(3x3/5x5/7x7/9x9), got {len(taps)} taps")
    if scale is None:
        scale = sum(taps)
    if int(scale) != scale or scale <= 0:
        raise ValueError(
            f"kernel {name!r}: scale must be a positive integer "
            f"(PIL default sum(taps) = {sum(taps)}), got {scale!r}")
    scale = int(scale)
    off2 = 2.0 * float(offset)
    if off2 != int(off2):
        raise ValueError(
            f"kernel {name!r}: offset must be a multiple of 0.5, "
            f"got {offset!r}")
    off2 = int(off2)
    num_bound = 2 * 255 * sum(abs(t) for t in taps) + scale * (abs(off2) + 1)
    if num_bound > _KERNEL_NUM_LIMIT:
        raise ValueError(
            f"kernel {name!r}: |taps|/scale/offset too large for exact "
            f"int32 arithmetic (bound {num_bound} > {_KERNEL_NUM_LIMIT})")
    rows = [list(taps[i * size:(i + 1) * size]) for i in range(size)]
    spec = {
        "taps": taps, "scale": scale, "off2": off2, "size": size,
        "flipped": tuple(tuple(r_) for r_ in rows[::-1]),
        "radius": size // 2,
    }
    prev = KERNEL_STAGES.get(name)
    if prev is not None:
        if prev == spec:
            return
        raise ValueError(f"kernel {name!r} already registered with a different spec")
    if name in FILTERS:
        raise ValueError(f"{name!r} is already a builtin filter name")
    KERNEL_STAGES[name] = spec
    FILTERS[name] = _make_kernel_stage(spec)
    ROWS_FILTERS[name] = _make_kernel_stage_rows(spec)
    FILTER_RADIUS[name] = spec["radius"]


# The PIL builtin convolution presets (Pillow's ImageFilter tap tables, as
# hipe_tpu registers them), as ``pil_*`` stages.
PIL_PRESETS = {
    "pil_blur": ((1, 1, 1, 1, 1,
                  1, 0, 0, 0, 1,
                  1, 0, 0, 0, 1,
                  1, 0, 0, 0, 1,
                  1, 1, 1, 1, 1), 16, 0),
    "pil_contour": ((-1, -1, -1, -1, 8, -1, -1, -1, -1), 1, 255),
    "pil_detail": ((0, -1, 0, -1, 10, -1, 0, -1, 0), 6, 0),
    "pil_edge_enhance": ((-1, -1, -1, -1, 10, -1, -1, -1, -1), 2, 0),
    "pil_edge_enhance_more": ((-1, -1, -1, -1, 9, -1, -1, -1, -1), 1, 0),
    "pil_emboss": ((-1, 0, 0, 0, 1, 0, 0, 0, 0), 1, 128),
    "pil_find_edges": ((-1, -1, -1, -1, 8, -1, -1, -1, -1), 1, 0),
    "pil_sharpen": ((-2, -2, -2, -2, 32, -2, -2, -2, -2), 16, 0),
    "pil_smooth": ((1, 1, 1, 1, 5, 1, 1, 1, 1), 13, 0),
    "pil_smooth_more": ((1, 1, 1, 1, 1,
                         1, 5, 5, 5, 1,
                         1, 5, 44, 5, 1,
                         1, 5, 5, 5, 1,
                         1, 1, 1, 1, 1), 100, 0),
}

for _nm, (_taps, _scale, _off) in PIL_PRESETS.items():
    register_kernel_filter(_nm, _taps, _scale, _off)


# ---- Generalized rank filters (PIL RankFilter / MedianFilter family) -----
#
# The rank-th smallest value of the clamped (2r+1)^2 window: PIL's
# ``RankFilter(size, rank)``, borders included (PIL replicates the border
# before ranking, the engine's clamp-to-edge rule).

RANK_STAGES: dict = {}


def _rank_select(vals, rank: int) -> torch.Tensor:
    """The rank-th smallest of the uint8 tensors ``vals``, elementwise.

    Bit-serial counting selection, most significant bit first: the rank-th
    smallest is >= c iff |{v < c}| <= rank, so 8 rounds of comparison
    counts fix one bit each. It reads the window through views, so no
    (n, ...) stack is ever made, and stays in uint8: values, candidates
    and counts (n <= 81) all fit. hipe_tpu runs an odd-even network up to
    25 values and this counting above; every exact selection agrees.
    """
    acc = torch.zeros_like(vals[0])
    for bit in range(7, -1, -1):
        cand = acc + (1 << bit)  # acc holds only the bits above `bit`
        cnt = torch.zeros_like(acc)
        for v in vals:
            cnt += v < cand
        acc = torch.where(cnt <= rank, cand, acc)
    return acc


def _make_rank_stage(size: int, rank: int):
    r = size // 2

    def op(x: torch.Tensor, *, h_axis: int = -3, w_axis: int = -2,
           h_pad: bool = True) -> torch.Tensor:
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        v = _stencil_r(x, h_axis, w_axis, h_pad, r, dtype=torch.uint8)
        return _rank_select([v(dy, dx) for dy in range(size) for dx in range(size)],
                            rank)

    return op


def _make_rank_stage_rows(size: int, rank: int):
    r = size // 2

    def op(x: torch.Tensor, channels: int, *, h_pad: bool = True) -> torch.Tensor:
        _check_rows(x, channels)
        v = _rows_stencil(x, channels, h_pad, r, dtype=torch.uint8)
        return _rank_select([v(dy, dx) for dy in range(size) for dx in range(-r, r + 1)],
                            rank)

    return op


def register_rank_filter(name: str, size: int, rank: int) -> None:
    """Register ``PIL.ImageFilter.RankFilter(size, rank)`` as a stage.

    size: odd window edge (3/5/7/9); rank: order statistic in
    [0, size*size). Re-registering the same name with an identical spec
    is a no-op; a conflicting spec, or the name of a builtin stage, raises.
    """
    if size not in (3, 5, 7, 9):
        raise ValueError(
            f"rank filter {name!r}: size must be odd 3..9, got {size} "
            "(PIL RankFilter semantics; larger windows would exceed the "
            "halo machinery's radius support)")
    if not (0 <= rank < size * size):
        raise ValueError(
            f"rank filter {name!r}: rank must be in [0, {size * size - 1}],"
            f" got {rank}")
    spec = (int(size), int(rank))
    prev = RANK_STAGES.get(name)
    if prev is not None:
        if prev == spec:
            return
        raise ValueError(
            f"rank filter {name!r} already registered with a different spec")
    if name in FILTERS:
        raise ValueError(f"{name!r} is already a builtin filter name")
    RANK_STAGES[name] = spec
    FILTERS[name] = _make_rank_stage(*spec)
    ROWS_FILTERS[name] = _make_rank_stage_rows(*spec)
    FILTER_RADIUS[name] = size // 2


# The 5x5/7x7/9x9 builtins of the family (the 3x3 ones are median, erode
# and dilate above): PIL MedianFilter(5/7/9), MinFilter(5), MaxFilter(5).
register_rank_filter("median5", 5, 12)
register_rank_filter("erode5", 5, 0)
register_rank_filter("dilate5", 5, 24)
register_rank_filter("median7", 7, 24)
register_rank_filter("median9", 9, 40)
