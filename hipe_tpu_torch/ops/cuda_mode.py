"""The mode filter on the card: the wrapper of kernel K12
(``csrc/mode_planar.cu``).

``hipe_tpu``'s mode filter is XLA ops and reaches no ``pallas_call``; on the
card the port runs PIL ``ImageFilter.ModeFilter(3 | 5)`` as one hand-written
kernel, one launch a call over the whole ``(N, H, W)`` planar stream: a
thread walks a column of a strip of rows with a sliding 256-bin histogram
of its window in shared memory. The kernel holds no temporaries in device
memory.

For a CUDA tensor :func:`mode_planar_cuda` checks its call, launches K12
once and raises on a CUDA error; for a CPU tensor it runs the plain PyTorch
version (:func:`hipe_tpu_torch.ops.equalize.mode_plain`, the pairwise
equality form), which is also what the kernel is held against on the card.
Its ``launches`` counts the kernel's launches. Empty planes launch nothing.
"""

from __future__ import annotations

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import equalize as eq
from hipe_tpu_torch.ops._build import I, L, P

SIZES = (3, 5)
# The kernel indexes a row and a column with 32-bit ints.
MAX_SIDE = 2 ** 31 - 1


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether contiguous ``a`` and ``b`` share any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


@_build.entry("hipe_mode_planar_u8", P, P, L, L, L, I)
def mode_planar_cuda(planes: torch.Tensor, size: int = 3, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """K12: PIL ``ModeFilter(size)`` (size 3 or 5) of each of contiguous
    ``(N, H, W)`` uint8 planes. ``out``, if given, is a contiguous
    ``(N, H, W)`` uint8 tensor on the same device that shares no byte with
    ``planes``: a thread reads rows that other threads write."""
    if planes.dtype != torch.uint8 or planes.dim() != 3:
        raise TypeError(f"mode_planar_cuda: expected (N, H, W) uint8 planes, got "
                        f"{planes.dtype} of shape {tuple(planes.shape)}")
    if size not in SIZES:
        raise ValueError(f"mode_planar_cuda: size must be 3 or 5, got {size}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mode_planar_cuda: unsupported device {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("mode_planar_cuda: planes must be contiguous")
    n, h, w = planes.shape
    if max(h, w) > MAX_SIDE:
        raise ValueError(f"mode_planar_cuda: a {h}x{w} plane has a side over {MAX_SIDE}")
    if out is not None:
        if (out.dtype != torch.uint8 or out.shape != planes.shape
                or out.device != planes.device or not out.is_contiguous()):
            raise ValueError(f"mode_planar_cuda: out must be a contiguous uint8 {(n, h, w)} "
                             f"tensor on {planes.device}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}"
                             + ("" if out.is_contiguous() else ", not contiguous"))
        if overlaps(out, planes):
            raise ValueError("mode_planar_cuda: out overlaps planes")
    if planes.device.type == "cpu":
        res = eq.mode_plain(planes, size)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(planes)
    if out.numel() == 0:
        return out
    mode_planar_cuda.launch(
        planes, lambda: f"mode_planar_u8 size {size} for {(n, h, w)} launch failed",
        planes.data_ptr(), out.data_ptr(), n, h, w, size)
    return out
