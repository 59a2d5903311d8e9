"""The binomial blur on the card: wrapper of kernel K1 (``csrc/blur_planar.cu``).

The counterpart of ``hipe_tpu.ops.pallas_blur``'s planar blur kernels:
K1 computes what ``_blur_mxu_kernel`` (``path="mxu"``), ``_blur_kernel``
(``path="vpu"``) and ``_chain_mxu_kernel`` on a one-stage gaussian chain
compute, as an exact integer stencil written for Hopper. Every other chain
runs the fused chain kernel K2 (:mod:`hipe_tpu_torch.ops.cuda_chain`).

For a CUDA tensor :func:`gaussian_blur_planar_cuda` launches K1 or raises;
for a CPU tensor it runs the plain PyTorch version
(:func:`hipe_tpu_torch.ops.blur.gaussian_blur_planar`), which is also what
the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops.blur import gaussian_blur_planar

# Output rows per thread block when the caller names none; the runner's
# autotune sweeps the alternatives.
DEFAULT_ROWS_PER_BLOCK = 16


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load_library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hipe_blur_planar_u8.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.hipe_blur_planar_u8.restype = ci
    lib.hipe_cuda_error_string.argtypes = [ci]
    lib.hipe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def out_rows(h: int, radius: int, h_pad: bool) -> int:
    """Rows of the blurred plane: H with clamping, H - 2r in valid mode."""
    return h if h_pad else h - 2 * radius


def gaussian_blur_planar_cuda(
    x: torch.Tensor,
    radius: int = 1,
    *,
    h_pad: bool = True,
    rows_per_block: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Binomial blur of planar ``(N, H, W)`` uint8 planes, radius 1-4.

    W clamps at its edges; H clamps with ``h_pad`` (output ``(N, H, W)``)
    and is valid-only without it (output ``(N, H - 2r, W)``). ``out``, if
    given, receives the result and must not share memory with ``x``.
    ``rows_per_block`` is K1's launch knob (output rows per thread block;
    at least the plane's rows means one block per plane).
    """
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise TypeError(
            f"expected a 3-D uint8 tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if not 1 <= radius <= 4:
        raise ValueError(f"radius must be 1-4, got {radius}")
    n, h, w = x.shape
    ho = out_rows(h, radius, h_pad)
    if ho < 1:
        raise ValueError(f"valid mode needs H > {2 * radius}, got H={h}")
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
            raise ValueError("out shares memory with x; the blur is out-of-place")
    if x.device.type == "cpu":
        y = gaussian_blur_planar(x, radius, h_pad=h_pad)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if out is None:
        out = torch.empty((n, ho, w), dtype=torch.uint8, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        rc = lib.hipe_blur_planar_u8(
            x.data_ptr(), out.data_ptr(), n, h, w, radius, int(h_pad), rpb,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.hipe_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"blur_planar_u8 launch failed for {(n, h, w)} r={radius} "
            f"h_pad={h_pad} rows_per_block={rpb}: {msg} (cudaError {rc})")
    gaussian_blur_planar_cuda.launches += 1
    return out


gaussian_blur_planar_cuda.launches = 0
