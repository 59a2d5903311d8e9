"""The JPEG codec's kernels on the card: wrappers of K6 and K7
(``csrc/dct_blocks.cu``) and K11 (``csrc/ycc_rows.cu``).

The counterpart of ``hipe_tpu.ops.pallas_dct``: K6 computes what
``_idct_kernel`` computes (dequantize, islow IDCT, range limit) and K7 what
``_fdct_kernel`` computes (level shift, islow fDCT, quantize), in the card's
layout: coefficients ``(B, Hb, Wb, 64)`` int16 in natural order and the
component's sample grid ``(B, Hb*8, Wb*8)`` uint8. K11 replaces no Pallas
kernel (``hipe_tpu`` upsamples and converts colour in XLA ops): it turns the
three sample grids of a 4:2:0 decode (jdsample.c's fancy h2v2 upsample) or
of one whose chroma is at the output's resolution into interleaved RGB rows
``(B, H, W*3)`` uint8 (jdcolor.c's ycc_rgb_convert), in one launch.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain PyTorch version (:func:`hipe_tpu_torch.ops.jpeg_decode.idct8x8_islow`,
:func:`hipe_tpu_torch.ops.jpeg_encode.fdct_quantize_plain`,
:func:`hipe_tpu_torch.ops.jpeg_decode.ycc_rows_plain`), which is also what
the kernels are held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.ops._build import I, P


def quant_table(qtable) -> np.ndarray:
    """A quant table as 64 uint32 in natural order; raises unless it has 64
    entries in 1..65535 (8- and 16-bit tables)."""
    q = np.asarray(qtable.cpu() if isinstance(qtable, torch.Tensor) else qtable)
    if q.shape != (64,):
        raise ValueError(f"expected a (64,) quant table, got shape {q.shape}")
    q = q.astype(np.int64)
    if q.min() < 1 or q.max() > 65535:
        raise ValueError(f"quant table entries must be in 1..65535, got {q.min()}..{q.max()}")
    return q.astype(np.uint32)


def _check(t: torch.Tensor, dtype: torch.dtype, what: str, align: int) -> None:
    """Raise unless ``t`` is a contiguous ``(B, Hb, Wb, 64)`` int16 or
    ``(B, H, W)`` uint8 tensor, ``align``-byte aligned on the card."""
    layout = "(B, Hb, Wb, 64) int16" if dtype == torch.int16 else "(B, Hb*8, Wb*8) uint8"
    if t.dtype != dtype or t.dim() != (4 if dtype == torch.int16 else 3):
        raise TypeError(f"{what}: expected a {layout} tensor, got {t.dtype} "
                        f"of shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{what} must be {align}-byte aligned on the card")


@_build.entry("hipe_dequant_idct_s16", P, P, P, I, I, I)
def dequant_idct_cuda(coefs: torch.Tensor, qtable, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """K6: dequantize + islow IDCT + range limit of a block grid.

    ``coefs``: ``(B, Hb, Wb, 64)`` int16 quantized coefficients in natural
    order; ``qtable``: the component's ``(64,)`` table. Returns the sample
    grid ``(B, Hb*8, Wb*8)`` uint8 (into ``out`` if given), bit-exact
    against libjpeg's jidctint.c with its int32 wrap-around.
    """
    _check(coefs, torch.int16, "coefficients", 2)
    if coefs.shape[-1] != 64:
        raise ValueError(f"coefficients must end in 64, got shape {tuple(coefs.shape)}")
    q = quant_table(qtable)
    b, hb, wb, _ = coefs.shape
    if out is not None:
        if out.shape != (b, hb * 8, wb * 8) or out.device != coefs.device:
            raise ValueError(f"out must be {(b, hb * 8, wb * 8)} on {coefs.device}")
        _check(out, torch.uint8, "out", 8)
    if coefs.device.type == "cpu":
        # Imported here: jpeg_decode imports this module.
        from hipe_tpu_torch.ops.jpeg_decode import idct8x8_islow

        y = idct8x8_islow(coefs, q)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((b, hb * 8, wb * 8), dtype=torch.uint8, device=coefs.device)
    dequant_idct_cuda.launch(
        coefs, lambda: f"dequant_idct_s16 launch failed for {(b, hb, wb)} blocks",
        coefs.data_ptr(), out.data_ptr(), q.ctypes.data, b, hb, wb)
    return out


@_build.entry("hipe_fdct_quantize_u8", P, P, P, I, I, I)
def fdct_quantize_cuda(grid: torch.Tensor, qtable, *,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """K7: level shift + islow fDCT + quantize of a padded sample grid.

    ``grid``: ``(B, Hb*8, Wb*8)`` uint8; ``qtable``: ``(64,)``. Returns
    ``(B, Hb, Wb, 64)`` int16 coefficients in natural order (into ``out``
    if given), bit-exact against libjpeg's jcfdctint.c and jcdct.c.
    """
    _check(grid, torch.uint8, "grid", 8)
    b, h, w = grid.shape
    if h % 8 or w % 8 or h == 0 or w == 0:
        raise ValueError(f"grid sides must be positive multiples of 8, got {(h, w)}")
    q = quant_table(qtable)
    hb, wb = h // 8, w // 8
    if out is not None:
        if out.shape != (b, hb, wb, 64) or out.device != grid.device:
            raise ValueError(f"out must be {(b, hb, wb, 64)} on {grid.device}")
        _check(out, torch.int16, "out", 16)
    if grid.device.type == "cpu":
        # Imported here: jpeg_encode imports this module.
        from hipe_tpu_torch.ops.jpeg_encode import fdct_quantize_plain

        y = fdct_quantize_plain(grid, q)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty((b, hb, wb, 64), dtype=torch.int16, device=grid.device)
    fdct_quantize_cuda.launch(
        grid, lambda: f"fdct_quantize_u8 launch failed for {(b, hb, wb)} blocks",
        grid.data_ptr(), out.data_ptr(), q.ctypes.data, b, hb, wb)
    return out


@_build.entry("hipe_ycc_rows_u8", P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I)
def ycc_rows_cuda(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, fancy: bool,
                  chroma_dims: tuple[int, int], out_dims: tuple[int, int], *,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """K11: upsample + YCbCr -> RGB of three sample grids to interleaved rows.

    ``y``, ``cb``, ``cr``: ``(B, rows, pitch)`` uint8 sample grids (each its
    own padded size). With ``fancy`` each chroma grid, cropped to
    ``chroma_dims`` (its downsampled dims), takes jdsample.c's h2v2 fancy
    upsample, edges replicated at those dims; without it the chroma grids
    are at the output's resolution. Returns ``(B, H, W*3)`` uint8 RGB rows,
    ``(H, W) = out_dims`` (into ``out`` if given), bit-exact against
    jdcolor.c's ycc_rgb_convert. jdsample.c's narrow-plane guard is the
    caller's: ``fancy`` computes the fancy filter at any width.
    """
    for t, what in ((y, "y"), (cb, "cb"), (cr, "cr")):
        _check(t, torch.uint8, what, 1)
        if t.shape[0] != y.shape[0] or t.device != y.device:
            raise ValueError(f"{what} must share y's batch {y.shape[0]} and device {y.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    (dh, dw), (oh, ow) = chroma_dims, out_dims
    f = 2 if fancy else 1
    if (min(dh, dw, oh, ow) < 1 or y.shape[1] < oh or y.shape[2] < ow
            or min(cb.shape[1], cr.shape[1]) < dh or min(cb.shape[2], cr.shape[2]) < dw
            or f * dh < oh or f * dw < ow):
        raise ValueError(f"grids {tuple(y.shape)}, {tuple(cb.shape)}, {tuple(cr.shape)} do not "
                         f"cover chroma dims {chroma_dims} and output {out_dims} "
                         f"(fancy={fancy})")
    b = y.shape[0]
    if out is not None:
        if out.shape != (b, oh, ow * 3) or out.device != y.device:
            raise ValueError(f"out must be {(b, oh, ow * 3)} on {y.device}")
        _check(out, torch.uint8, "out", 1)
    if y.device.type == "cpu":
        # Imported here: jpeg_decode imports this module.
        from hipe_tpu_torch.ops.jpeg_decode import ycc_rows_plain

        rows = ycc_rows_plain(y, cb, cr, fancy, chroma_dims, out_dims)
        return rows if out is None else out.copy_(rows)
    if out is None:
        out = torch.empty((b, oh, ow * 3), dtype=torch.uint8, device=y.device)
    ycc_rows_cuda.launch(
        y, lambda: f"ycc_rows_u8 launch failed for {b} images of {out_dims}",
        y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out.data_ptr(), b, *y.shape[1:],
        *cb.shape[1:], *cr.shape[1:], dh, dw, oh, ow, int(fancy))
    return out
