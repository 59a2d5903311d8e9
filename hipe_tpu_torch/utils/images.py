"""Image layout utilities (copy of ``hipe_tpu.utils.images``' numpy helpers).

The kernels work on planar ``(N*C, H, W)`` planes, one contiguous plane per
(image, channel); these convert to and from channels-last batches, and
:func:`replicate_stream` simulates the reference's replicated stream. The
streams' default image is :func:`checker_image` (``hipe_tpu``'s default
JPEG assets are not in the repository); JPEG files go through
:mod:`hipe_tpu_torch.io_.jpeg`.
"""

from __future__ import annotations

import numpy as np


def hwc_to_planar(batch: np.ndarray) -> np.ndarray:
    """(B, H, W, C) -> (B*C, H, W): one contiguous plane per image-channel."""
    b, h, w, c = batch.shape
    return np.ascontiguousarray(batch.transpose(0, 3, 1, 2)).reshape(b * c, h, w)


def planar_to_hwc(planes: np.ndarray, channels: int) -> np.ndarray:
    """(B*C, H, W) -> (B, H, W, C); inverse of :func:`hwc_to_planar`."""
    n, h, w = planes.shape
    b = n // channels
    return np.ascontiguousarray(planes.reshape(b, channels, h, w).transpose(0, 2, 3, 1))


def replicate_stream(image: np.ndarray, count: int) -> np.ndarray:
    """Simulate an image stream by replication (heterogeneous_blur.c:431-442)."""
    return np.broadcast_to(image, (count,) + image.shape)


def checker_image(h: int = 64, w: int = 64, c: int = 3, seed: int = 0) -> np.ndarray:
    """Deterministic random uint8 test image (no file IO needed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
