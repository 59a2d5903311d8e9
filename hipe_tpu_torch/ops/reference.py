"""NumPy oracles of the stencil filters (copies from ``hipe_tpu.ops.reference``).

The reference OpenCL kernel (``gaussian_kernel.cl:19-72``) is a 3x3 binomial
blur with clamp-to-edge borders, fp32 accumulation and a truncating uint8
store. Every weight is a multiple of 2^-4r and every input a uint8, so that
pipeline is bit-identical to the integer ``(sum_i w_int_i * x_i) >> 4r``,
which is what this oracle computes and what every kernel implements.

These functions are copied rather than imported: importing anything
from ``hipe_tpu`` imports ``jax``, and the port never does. The tests hold
the copies equal to the originals.
"""

from __future__ import annotations

import numpy as np


def binomial_taps(radius: int) -> tuple[np.ndarray, int]:
    """Integer binomial taps of length 2*radius+1 and the per-axis shift.

    radius=1 -> (1,2,1), shift 2 per axis (4 for the 2D kernel);
    radius=2 -> (1,4,6,4,1), shift 4; radius=4 -> C(8,k), shift 8.
    """
    taps = np.array([1], dtype=np.int64)
    for _ in range(2 * radius):
        taps = np.convolve(taps, [1, 1])
    shift = 2 * radius  # sum(taps) == 2**(2*radius)
    return taps, shift


def _pad_edge(img: np.ndarray, radius: int) -> np.ndarray:
    pad = [(radius, radius), (radius, radius)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def gaussian_blur_int_oracle(img: np.ndarray, radius: int = 1) -> np.ndarray:
    """Integer path: separable ``(colpass(rowpass(x))) >> 2*shift``.

    ``img`` is (H, W) or (H, W, C) uint8; borders clamp to the edge.
    """
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {img.dtype}")
    taps, shift = binomial_taps(radius)
    H, W = img.shape[:2]
    padded = _pad_edge(img, radius).astype(np.int64)
    # Row pass (along W), then column pass (along H).
    row = np.zeros((H + 2 * radius,) + img.shape[1:], dtype=np.int64)
    for dx in range(2 * radius + 1):
        row += taps[dx] * padded[:, dx : dx + W]
    acc = np.zeros(img.shape, dtype=np.int64)
    for dy in range(2 * radius + 1):
        acc += taps[dy] * row[dy : dy + H]
    return (acc >> (2 * shift)).astype(np.uint8)


def sharpen3x3_oracle(img: np.ndarray) -> np.ndarray:
    """3x3 unsharp kernel [[0,-1,0],[-1,5,-1],[0,-1,0]], clamp to [0,255].

    The reference has no sharpen; this defines the framework's filter-chain
    semantics (BASELINE.json config 4): integer arithmetic, clamp-to-edge
    borders, saturating uint8 store.
    """
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {img.dtype}")
    H, W = img.shape[:2]
    p = _pad_edge(img, 1).astype(np.int64)
    c = p[1 : 1 + H, 1 : 1 + W]
    up = p[0:H, 1 : 1 + W]
    dn = p[2 : 2 + H, 1 : 1 + W]
    lf = p[1 : 1 + H, 0:W]
    rt = p[1 : 1 + H, 2 : 2 + W]
    out = 5 * c - up - dn - lf - rt
    return np.clip(out, 0, 255).astype(np.uint8)


def sobel_edge_oracle(img: np.ndarray) -> np.ndarray:
    """Sobel |gx|+|gy| edge magnitude, clamp to [0,255], per channel."""
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {img.dtype}")
    H, W = img.shape[:2]
    p = _pad_edge(img, 1).astype(np.int64)

    def sl(dy, dx):
        return p[dy : dy + H, dx : dx + W]

    gx = (sl(0, 2) + 2 * sl(1, 2) + sl(2, 2)) - (sl(0, 0) + 2 * sl(1, 0) + sl(2, 0))
    gy = (sl(2, 0) + 2 * sl(2, 1) + sl(2, 2)) - (sl(0, 0) + 2 * sl(0, 1) + sl(0, 2))
    return np.clip(np.abs(gx) + np.abs(gy), 0, 255).astype(np.uint8)


def kernel_oracle(img: np.ndarray, taps, scale: int, offset: float) -> np.ndarray:
    """Exact-arithmetic PIL ``ImageFilter.Kernel`` semantics, int64.

    Taps in PIL order (row 0 first; PIL applies kernel rows bottom-up, so
    the correlation uses the row-reversed table); clamp-to-edge borders
    (PIL copies border pixels unfiltered: equality with PIL holds on the
    interior); round-half-up by the integer identity
    floor(acc/scale + offset + 1/2) = (2*acc + scale*(2*offset+1)) // (2*scale).
    The oracle of the sharpness op's SMOOTH plane.
    """
    size = int(round(len(taps) ** 0.5))
    r = size // 2
    h, w = img.shape[:2]
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    xp = np.pad(img, pad, mode="edge").astype(np.int64)
    t = np.array(taps, np.int64).reshape(size, size)[::-1]
    acc = np.zeros(img.shape, np.int64)
    for dy in range(size):
        for dx in range(size):
            acc += t[dy, dx] * xp[dy:dy + h, dx:dx + w]
    off2 = int(2 * offset)
    if off2 != 2 * offset:
        raise ValueError(f"offset {offset} is not a multiple of 0.5")
    num = 2 * acc + int(scale) * (off2 + 1)
    return np.clip(num // (2 * int(scale)), 0, 255).astype(np.uint8)
