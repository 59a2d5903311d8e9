"""Equalize on the card: wrappers of kernels K8, K9 and K10
(``csrc/equalize_planar.cu``).

``hipe_tpu``'s equalize is XLA ops and reaches no ``pallas_call``; on the
card the port runs its three stages as hand-written kernels, one launch a
stage over the whole ``(N, H, W)`` planar stream:

- :func:`histogram_planes_cuda` (K8): ``(N, H, W)`` uint8 -> ``(N, 256)``
  int32 counts, each plane read once;
- :func:`equalize_lut_cuda` (K9): the counts -> ``(N, 256)`` uint8 tables,
  ``equalize_lut``'s integer arithmetic;
- :func:`apply_lut_planar_cuda` (K10): ``out[n, p] = lut[n, planes[n, p]]``.

For a CUDA tensor each wrapper checks its call, launches its kernel once and
raises on a CUDA error; for a CPU tensor it runs the plain PyTorch version
(:func:`hipe_tpu_torch.ops.equalize.histogram_planes`,
:func:`~hipe_tpu_torch.ops.equalize.equalize_lut`,
:func:`~hipe_tpu_torch.ops.equalize.apply_lut`), which is also what the
kernels are held against on the card. Each wrapper's ``launches`` counts its
kernel's launches. Empty planes launch nothing.
"""

from __future__ import annotations

import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops import equalize as eq
from hipe_tpu_torch.ops._build import L, P

BINS = 256
# The counts are int32, so a plane holds at most this many pixels.
MAX_PLANE_PIXELS = 2 ** 31 - 1


def _check_planes(planes: torch.Tensor, what: str) -> None:
    if planes.dtype != torch.uint8 or planes.dim() != 3:
        raise TypeError(f"{what}: expected (N, H, W) uint8 planes, got {planes.dtype} "
                        f"of shape {tuple(planes.shape)}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {planes.device}")
    if planes.device.type == "cuda" and not planes.is_contiguous():
        raise ValueError(f"{what}: planes must be contiguous")
    if planes.shape[1] * planes.shape[2] > MAX_PLANE_PIXELS:
        raise ValueError(f"{what}: a plane of {planes.shape[1]}x{planes.shape[2]} pixels "
                         f"is over the {MAX_PLANE_PIXELS} its int32 counts hold")


def _check_table(t: torch.Tensor, n: int, dtype: torch.dtype, device: torch.device,
                 align: int, what: str) -> None:
    """Raise unless ``t`` is a contiguous ``(n, 256)`` ``dtype`` tensor on
    ``device``, ``align``-byte aligned on the card."""
    if (t.dtype != dtype or tuple(t.shape) != (n, BINS) or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} {(n, BINS)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                         + ("" if t.is_contiguous() else ", not contiguous"))
    if device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{what} must be {align}-byte aligned on the card")


def _overlaps_partly(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether contiguous ``a`` and ``b`` share bytes without being the same bytes."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 != b0 and a0 < b0 + b.numel() and b0 < a0 + a.numel()


@_build.entry("hipe_equalize_histogram_u8", P, P, L, L)
def histogram_planes_cuda(planes: torch.Tensor, *,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """K8: per-plane 256-bin histograms, ``(N, H, W)`` uint8 -> ``(N, 256)``
    int32 (in ``out`` if given: contiguous, 16-byte aligned on the card)."""
    _check_planes(planes, "histogram_planes_cuda")
    n, h, w = planes.shape
    if out is not None:
        _check_table(out, n, torch.int32, planes.device, 16, "histogram_planes_cuda: out")
    if planes.device.type == "cpu":
        hist = eq.histogram_planes(planes)
        return hist if out is None else out.copy_(hist)
    if out is None:
        out = torch.empty((n, BINS), dtype=torch.int32, device=planes.device)
    if n == 0 or h * w == 0:
        return out.zero_()
    histogram_planes_cuda.launch(
        planes, lambda: f"equalize_histogram_u8 for {(n, h, w)} launch failed",
        planes.data_ptr(), out.data_ptr(), n, h * w)
    return out


@_build.entry("hipe_equalize_lut_u8", P, P, L, L)
def equalize_lut_cuda(hist: torch.Tensor, npix: int, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """K9: PIL ``ImageOps.equalize`` tables from ``(N, 256)`` int32
    histograms (counts >= 0) of planes of ``npix`` pixels: ``(N, 256)``
    uint8 (in ``out`` if given: contiguous, 8-byte aligned on the card)."""
    if hist.dim() != 2:
        raise TypeError(f"equalize_lut_cuda: expected (N, 256) int32 histograms, got "
                        f"{hist.dtype} of shape {tuple(hist.shape)}")
    n = hist.shape[0]
    _check_table(hist, n, torch.int32, hist.device, 16, "equalize_lut_cuda: hist")
    if npix < 0:
        raise ValueError(f"equalize_lut_cuda: npix must be >= 0, got {npix}")
    if out is not None:
        _check_table(out, n, torch.uint8, hist.device, 8, "equalize_lut_cuda: out")
    if hist.device.type == "cpu":
        lut = eq.equalize_lut(hist, npix)
        return lut if out is None else out.copy_(lut)
    if out is None:
        out = torch.empty((n, BINS), dtype=torch.uint8, device=hist.device)
    if n == 0:
        return out
    equalize_lut_cuda.launch(
        hist, lambda: f"equalize_lut_u8 for {n} planes of {npix} pixels launch failed",
        hist.data_ptr(), out.data_ptr(), n, int(npix))
    return out


@_build.entry("hipe_equalize_apply_u8", P, P, P, L, L)
def apply_lut_planar_cuda(planes: torch.Tensor, lut: torch.Tensor, *,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """K10: ``out[n, p] = lut[n, planes[n, p]]`` for ``(N, H, W)`` uint8
    planes and ``(N, 256)`` uint8 tables. ``out``, if given, is a
    contiguous ``(N, H, W)`` uint8 tensor; it may be ``planes`` itself, but
    must not overlap it otherwise."""
    _check_planes(planes, "apply_lut_planar_cuda")
    n, h, w = planes.shape
    _check_table(lut, n, torch.uint8, planes.device, 1, "apply_lut_planar_cuda: lut")
    if out is not None:
        if (out.dtype != torch.uint8 or out.shape != planes.shape
                or out.device != planes.device or not out.is_contiguous()):
            raise ValueError(f"apply_lut_planar_cuda: out must be a contiguous uint8 "
                             f"{(n, h, w)} tensor on {planes.device}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
        if planes.is_contiguous() and _overlaps_partly(out, planes):
            raise ValueError("apply_lut_planar_cuda: out overlaps planes without being it")
    if planes.device.type == "cpu":
        res = eq.apply_lut(planes, lut)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(planes)
    if out.numel() == 0:
        return out
    apply_lut_planar_cuda.launch(
        planes, lambda: f"equalize_apply_u8 for {(n, h, w)} launch failed",
        planes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, h * w)
    return out
