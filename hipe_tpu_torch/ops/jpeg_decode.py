"""Device-side JPEG decode: dequantize + IDCT + upsample + colour convert.

The counterpart of ``hipe_tpu.ops.jpeg_decode`` for full-size decodes of
1- and 3-component streams. The host decodes the entropy layer
(:mod:`hipe_tpu_torch.io_.jpeg`); the card finishes the decode, batched over
images. Every step is libjpeg's default integer pipeline, bit for bit:
``jpeg_idct_islow`` (jidctint.c, int32 with its wrap-around and the
range-limit table), the fancy upsamplers of jdsample.c (with its
narrow-plane replication guard) and ``ycc_rgb_convert`` (jdcolor.c).

On a CUDA tensor the dequantize + IDCT of each component is kernel K6
(:func:`hipe_tpu_torch.ops.cuda_dct.dequant_idct_cuda`), one launch a
component, straight to the component's sample grid. Upsampling and colour
conversion of a 3-component decode whose two chroma planes both take the
fancy h2v2 upsample (4:2:0 at full size) or none (4:4:4, and 4:2:0 at 1/2,
1/4 and 1/8, where the scaled sizes absorb the ratio) go through K11's
wrapper (:func:`hipe_tpu_torch.ops.cuda_dct.ycc_rows_cuda`), straight to
the interleaved rows (:func:`ycc_rows_fancy` chooses, from the geometry):
one launch a call on the card, its plain version :func:`ycc_rows_plain` on
CPU tensors. Every other geometry (4:2:2, 4:4:0, replicated ratios, the
narrow-plane guard, CMYK/YCCK, gray) upsamples and converts in plain
PyTorch on either device, as ``hipe_tpu`` does in XLA ops, in chunks of
:data:`CHUNK_PIXELS` output pixels so their int32 temporaries stay small.
The plain IDCT below (:func:`_dequant_planes`, :func:`_idct_planes_core`)
is K6's plain version and :func:`ycc_rows_plain` K11's: the yardsticks the
kernels are held against.

Besides 1- and 3-component streams it decodes Adobe CMYK and YCCK
(jdcolor.c's null and ycck_cmyk_convert), the luma alone of a colour stream
(:func:`gray_geometry`, libjpeg's ``JCS_GRAYSCALE`` output), and 1/2, 1/4
and 1/8 scaled decodes (:func:`decode_planes_scaled`): the reduced IDCTs of
jidctred.c as torch ops, as ``hipe_tpu`` has them in XLA ops, and K6 for a
component whose scaled DCT size stays 8.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hipe_tpu_torch.ops.cuda_dct import dequant_idct_cuda, quant_table, ycc_rows_cuda
from hipe_tpu_torch.profiling.trace import span

# jidctint.c fixed-point constants (CONST_BITS = 13).
CONST_BITS = 13
PASS1_BITS = 2
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172

# jidctred.c fixed-point constants (the reduced IDCTs, CONST_BITS = 13).
_R_0_211164243 = 1730
_R_0_509795579 = 4176
_R_0_601344887 = 4926
_R_0_720959822 = 5906
_R_0_850430095 = 6967
_R_1_061594337 = 8697
_R_1_272758580 = 10426
_R_1_451774981 = 11893
_R_2_172734803 = 17799
_R_3_624509785 = 29692

# jdcolor.c constants (SCALEBITS = 16).
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_FIX_1_40200 = _fix(1.40200)
_FIX_1_77200 = _fix(1.77200)
_FIX_0_71414 = _fix(0.71414)
_FIX_0_34414 = _fix(0.34414)

# Output pixels a chunk of the torch work between the kernels (1000 images
# of 256x256): its int32 temporaries take 262 MB each, where the whole
# 5000-image stream's would take 1.3 GB each.
CHUNK_PIXELS = 1000 * 256 * 256


def _chunks(batch: int, pixels: int) -> list[slice]:
    """Slices of the batch axis, each at most CHUNK_PIXELS (one image at least)."""
    k = max(1, CHUNK_PIXELS // max(pixels, 1))
    return [slice(i, min(i + k, batch)) for i in range(0, batch, k)]


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """DESCALE(x, n) = arithmetic shift with round-half-up (jpegint.h)."""
    return (x + (1 << (n - 1))) >> n


def _range_limit(val: torch.Tensor) -> torch.Tensor:
    """libjpeg's post-IDCT range-limit table (jdmaster.c), indexed by
    ``val & 1023``: clamp(val + 128, 0, 255) in range, and far-out values
    wrap exactly as the table does."""
    m = val & 1023
    return torch.where(m < 128, m + 128,
                       torch.where(m < 512, 255, torch.where(m < 896, 0, m - 896)))


def _idct_1d(d: list, final: bool) -> list:
    """One 8-point islow IDCT pass over 8 int32 tensors (jidctint.c).

    ``final=False``: column pass, descaled by CONST_BITS - PASS1_BITS;
    ``final=True``: row pass, descaled by CONST_BITS + PASS1_BITS + 3.
    int32 throughout: products and shifts wrap as the reference's do.
    """
    shift = (CONST_BITS - PASS1_BITS) if not final else (CONST_BITS + PASS1_BITS + 3)
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F_0_541196100
    t2 = z1 - z3 * _F_1_847759065
    t3 = z1 + z2 * _F_0_765366865
    z2, z3 = d[0], d[4]
    t0 = (z2 + z3) << CONST_BITS
    t1 = (z2 - z3) << CONST_BITS
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * _F_1_175875602
    o0 = o0 * _F_0_298631336
    o1 = o1 * _F_2_053119869
    o2 = o2 * _F_3_072711026
    o3 = o3 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    return [_descale(t10 + o3, shift), _descale(t11 + o2, shift),
            _descale(t12 + o1, shift), _descale(t13 + o0, shift),
            _descale(t13 - o0, shift), _descale(t12 - o1, shift),
            _descale(t11 - o2, shift), _descale(t10 - o3, shift)]


def _dequant_planes(coefs: torch.Tensor, qtable) -> torch.Tensor:
    """(..., Hb, Wb, 64) coefficients -> (..., Hb, Wb, 8, 8) int32 blocks,
    dequantized (the product wraps in int32, as the reference's does)."""
    q = torch.from_numpy(quant_table(qtable).astype(np.int32)).to(coefs.device)
    return (coefs.to(torch.int32) * q).reshape(*coefs.shape[:-1], 8, 8)


def _idct_planes_core(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) dequantized int32 blocks -> (..., 8, 8) uint8 samples.

    Column pass (each column walks the rows), then row pass, then the range
    limit: the jidctint.c pipeline, vectorized over every block at once.
    """
    ws = torch.stack(_idct_1d([blocks[..., r, :] for r in range(8)], final=False), dim=-2)
    out = torch.stack(_idct_1d([ws[..., :, c] for c in range(8)], final=True), dim=-1)
    return _range_limit(out).to(torch.uint8)


def _idct4_1d(d: list, final: bool) -> list:
    """One 4-point reduced IDCT pass (jidctred.c jpeg_idct_4x4) over the 7
    coefficient rows or columns it uses, in index order 0, 1, 2, 3, 5, 6, 7
    (frequency 4 never reaches a 4-point output). int32, as islow's."""
    d0, d1, d2, d3, d5, d6, d7 = d
    shift = (CONST_BITS - PASS1_BITS + 1) if not final else (CONST_BITS + PASS1_BITS + 3 + 1)
    t0 = d0 << (CONST_BITS + 1)
    t2 = d2 * _F_1_847759065 - d6 * _F_0_765366865
    t10, t12 = t0 + t2, t0 - t2
    o0 = (d7 * -_R_0_211164243 + d5 * _R_1_451774981
          + d3 * -_R_2_172734803 + d1 * _R_1_061594337)
    o2 = (d7 * -_R_0_509795579 + d5 * -_R_0_601344887
          + d3 * _F_0_899976223 + d1 * _F_2_562915447)
    return [_descale(t10 + o2, shift), _descale(t12 + o0, shift),
            _descale(t12 - o0, shift), _descale(t10 - o2, shift)]


def _idct2_1d(d: list, final: bool) -> list:
    """One 2-point reduced IDCT pass (jidctred.c jpeg_idct_2x2) over the 5
    coefficient rows or columns it uses, in index order 0, 1, 3, 5, 7 (the
    even frequencies 2, 4, 6 never reach a 2-point output)."""
    d0, d1, d3, d5, d7 = d
    shift = (CONST_BITS - PASS1_BITS + 2) if not final else (CONST_BITS + PASS1_BITS + 3 + 2)
    t10 = d0 << (CONST_BITS + 2)
    t0 = (d7 * -_R_0_720959822 + d5 * _R_0_850430095
          + d3 * -_R_1_272758580 + d1 * _R_3_624509785)
    return [_descale(t10 + t0, shift), _descale(t10 - t0, shift)]


# Reduced IDCT size -> (the coefficient indices it uses, its 1-D pass).
_REDUCED = {4: ((0, 1, 2, 3, 5, 6, 7), _idct4_1d), 2: ((0, 1, 3, 5, 7), _idct2_1d)}


def _idct_planes_reduced(blocks: torch.Tensor, ssize: int) -> torch.Tensor:
    """(..., 8, 8) dequantized int32 blocks -> (..., ssize, ssize) uint8
    samples: jidctred.c's jpeg_idct_4x4, 2x2 and 1x1 (the DC alone), and the
    full islow IDCT at 8. Column pass, row pass, range limit, as
    :func:`_idct_planes_core`."""
    if ssize == 8:
        return _idct_planes_core(blocks)
    if ssize == 1:
        return _range_limit(_descale(blocks[..., :1, :1], 3)).to(torch.uint8)
    if ssize not in _REDUCED:
        raise ValueError(f"unsupported reduced IDCT size: {ssize}")
    used, pass1d = _REDUCED[ssize]
    idx = torch.tensor(used, device=blocks.device)
    sel = blocks.index_select(-2, idx).index_select(-1, idx)
    ws = torch.stack(pass1d([sel[..., i, :] for i in range(len(used))], final=False), dim=-2)
    out = torch.stack(pass1d([ws[..., :, j] for j in range(len(used))], final=True), dim=-1)
    return _range_limit(out).to(torch.uint8)


def _grid_from_planes(blocks: torch.Tensor) -> torch.Tensor:
    """(..., Hb, Wb, s, s) blocks -> the (..., Hb*s, Wb*s) sample grid."""
    *lead, hb, wb, s, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, hb * s, wb * s)


def idct8x8_islow(coefs: torch.Tensor, qtable) -> torch.Tensor:
    """Dequantize + 2-D islow IDCT of a block grid in plain PyTorch (K6's
    plain version). ``coefs``: (..., Hb, Wb, 64) int16 in natural order;
    returns the (..., Hb*8, Wb*8) uint8 sample grid."""
    return _grid_from_planes(_idct_planes_core(_dequant_planes(coefs, qtable)))


def _clamp_rows(x: torch.Tensor, offset: int) -> torch.Tensor:
    """Row-shifted copy with edge replication."""
    if offset == -1:
        return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    if offset == 1:
        return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    raise ValueError(offset)


def _clamp_cols(x: torch.Tensor, offset: int) -> torch.Tensor:
    if offset == -1:
        return torch.cat([x[..., :, :1], x[..., :, :-1]], dim=-1)
    if offset == 1:
        return torch.cat([x[..., :, 1:], x[..., :, -1:]], dim=-1)
    raise ValueError(offset)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Elementwise interleave of two same-shape tensors along ``dim`` (< 0)."""
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([a, b], dim=dim).reshape(shape)


def fancy_upsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """2x2 triangular upsample, bit-exact vs jdsample.c h2v2_fancy_upsample:
    (9 nearest + 3 + 3 + 1 diagonal) with +8/+7 rounding by column parity,
    edges replicated. (..., h, w) -> (..., 2h, 2w) int16 (sums <= 4088)."""
    x = plane.to(torch.int16)
    cs = _interleave(3 * x + _clamp_rows(x, -1), 3 * x + _clamp_rows(x, 1), -2)
    return _interleave((3 * cs + _clamp_cols(cs, -1) + 8) >> 4,
                       (3 * cs + _clamp_cols(cs, 1) + 7) >> 4, -1)


def fancy_upsample_h2v1(plane: torch.Tensor) -> torch.Tensor:
    """2x1 triangular upsample, bit-exact vs jdsample.c h2v1_fancy_upsample."""
    x = plane.to(torch.int16)
    return _interleave((3 * x + _clamp_cols(x, -1) + 1) >> 2,
                       (3 * x + _clamp_cols(x, 1) + 2) >> 2, -1)


def fancy_upsample_h1v2(plane: torch.Tensor) -> torch.Tensor:
    """1x2 (4:4:0) triangular upsample, bit-exact vs libjpeg-turbo's
    h1v2_fancy_upsample: the vertical transpose of h2v1."""
    x = plane.to(torch.int16)
    return _interleave((3 * x + _clamp_rows(x, -1) + 1) >> 2,
                       (3 * x + _clamp_rows(x, 1) + 2) >> 2, -2)


def _replicate(plane: torch.Tensor, hr: int, vr: int) -> torch.Tensor:
    """Plain pixel replication (jdsample.c int_upsample) by (hr, vr)."""
    x = plane.to(torch.int16)
    if vr > 1:
        x = x.repeat_interleave(vr, dim=-2)
    if hr > 1:
        x = x.repeat_interleave(hr, dim=-1)
    return x


def upsample_component(plane: torch.Tensor, hr: int, vr: int) -> torch.Tensor:
    """Upsample one component by (hr, vr), as jdsample.c selects: identity
    at (1, 1), the fancy filters at (2, 1)/(1, 2)/(2, 2), replication for
    every other integer ratio. jdsample.c's narrow-plane guard: with a
    horizontal ratio of 2 and a downsampled width of 2 or less the
    component replicates on both axes. Returns int16 at (..., h*vr, w*hr).
    """
    if (hr, vr) == (1, 1):
        return plane.to(torch.int16)
    if hr == 2 and plane.shape[-1] <= 2:
        return _replicate(plane, hr, vr)
    if (hr, vr) == (2, 2):
        return fancy_upsample_h2v2(plane)
    if (hr, vr) == (2, 1):
        return fancy_upsample_h2v1(plane)
    if (hr, vr) == (1, 2):
        return fancy_upsample_h1v2(plane)
    return _replicate(plane, hr, vr)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Fixed-point YCbCr -> RGB, bit-exact vs jdcolor.c: (..., H, W) samples
    in [0, 255] -> (..., H, W, 3) uint8. The range limit is a clamp: y plus
    the table term always lands in the table's simple segment."""
    y = y.to(torch.int32)
    cbc = cb.to(torch.int32) - 128
    crc = cr.to(torch.int32) - 128
    r = y + ((_FIX_1_40200 * crc + _ONE_HALF) >> _SCALEBITS)
    b = y + ((_FIX_1_77200 * cbc + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_FIX_0_34414 * cbc + _ONE_HALF + -_FIX_0_71414 * crc) >> _SCALEBITS)
    return torch.stack([r, g, b], dim=-1).clamp_(0, 255).to(torch.uint8)


def _rgb_rows(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Colour-convert and interleave the channels: (..., h, w*3) uint8."""
    rgb = ycc_to_rgb(y, cb, cr)
    return rgb.reshape(*rgb.shape[:-2], rgb.shape[-2] * 3)


def _cmyk_rows(comps: list, color: int) -> torch.Tensor:
    """Four full-size sample grids (..., H, W) -> interleaved CMYK rows
    (..., H, W*4) uint8. YCCK (``color`` 5, Adobe transform 2): jdcolor.c's
    ycck_cmyk_convert, the YCbCr -> RGB conversion of components 0-2
    inverted (255 - x) and K as it is; CMYK (4): every component as it is."""
    if color == 5:
        rgb = ycc_to_rgb(comps[0], comps[1], comps[2])
        out = torch.cat([255 - rgb.to(torch.int32), comps[3].to(torch.int32)[..., None]],
                        dim=-1).to(torch.uint8)
    else:
        out = torch.stack([c.to(torch.uint8) for c in comps], dim=-1)
    return out.reshape(*out.shape[:-2], out.shape[-2] * 4)


def ycc_rows_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, fancy: bool,
                   chroma_dims: tuple[int, int], out_dims: tuple[int, int]) -> torch.Tensor:
    """K11's plain version (:func:`hipe_tpu_torch.ops.cuda_dct.ycc_rows_cuda`),
    in batch chunks: the chroma grids cropped to ``chroma_dims`` and, with
    ``fancy``, upsampled by :func:`fancy_upsample_h2v2`; every grid cropped
    to ``out_dims``; then :func:`ycc_to_rgb` -> ``(B, H, W*3)`` uint8 rows."""
    (dh, dw), (oh, ow) = chroma_dims, out_dims
    out = torch.empty((y.shape[0], oh, ow * 3), dtype=torch.uint8, device=y.device)
    for s in _chunks(y.shape[0], oh * ow):
        chroma = [c[s, :dh, :dw] for c in (cb, cr)]
        if fancy:
            chroma = [fancy_upsample_h2v2(c) for c in chroma]
        out[s] = _rgb_rows(y[s, :oh, :ow], *(c[..., :oh, :ow] for c in chroma))
    return out


def _ratios(geo: "DecodeGeometry", sizes: tuple, mins: int) -> list:
    """Each component's upsampling ratio (hr, vr) at scaled DCT sizes
    ``sizes`` and luma size ``mins``."""
    return [(geo.max_h * mins // (h * ss), geo.max_v * mins // (v * ss))
            for (h, v, _, _), ss in zip(geo.comps, sizes)]


def ycc_rows_fancy(geo: "DecodeGeometry", scale_denom: int) -> bool | None:
    """Whether K11 upsamples this decode's chroma, or None where the torch
    path keeps it: True where both chroma planes take
    :func:`fancy_upsample_h2v2` (ratio (2, 2), not under the narrow-plane
    guard); False where neither is upsampled (ratio (1, 1)). Only
    3-component decodes. (A 1/8 decode, which replicates every ratio, never
    leaves (2, 2): the scaled sizes absorb it.)"""
    if geo.ncomps != 3:
        return None
    sizes, mins = scaled_sizes(geo, scale_denom), _MIN_SCALED[scale_denom]
    luma, cb, cr = _ratios(geo, sizes, mins)
    if luma != (1, 1) or cb != cr:
        return None
    if cb == (1, 1):
        return False
    return True if cb == (2, 2) and _scaled_down_dims(geo, 1, sizes[1])[1] > 2 else None


def _upsampled(geo: "DecodeGeometry", grids: list, s: slice, sizes: tuple, mins: int,
               out_h: int, out_w: int) -> list:
    """Batch chunk ``s`` of every component's sample grid, cropped to its
    (scaled) downsampled dims, upsampled to the output (int16; a component
    at the output's resolution stays uint8) and cropped to (out_h, out_w).
    ``sizes`` are the components' scaled DCT sizes and ``mins`` the luma's
    (all 8 at full size). libjpeg replicates every ratio at ``mins`` 1 (a
    1/8 decode); otherwise it selects as :func:`upsample_component`, whose
    narrow-plane guard then acts on the scaled width."""
    out = []
    for ci, (g, (hr, vr)) in enumerate(zip(grids, _ratios(geo, sizes, mins))):
        dh, dw = _scaled_down_dims(geo, ci, sizes[ci])
        x = g[s, :dh, :dw]
        if (hr, vr) != (1, 1):
            x = _replicate(x, hr, vr) if mins == 1 else upsample_component(x, hr, vr)
        out.append(x[..., :out_h, :out_w])
    return out


class DecodeGeometry(NamedTuple):
    """Shape and sampling of one stream (the batching key with its tables)."""

    width: int
    height: int
    ncomps: int
    # Per component: (h_samp, v_samp, width_in_blocks, height_in_blocks).
    comps: tuple[tuple[int, int, int, int], ...]
    max_h: int
    max_v: int
    # libjpeg J_COLOR_SPACE of a 4-component stream (4 CMYK, 5 YCCK); 3 else.
    color: int = 3


def geometry_of(co) -> DecodeGeometry:
    """DecodeGeometry of an :class:`hipe_tpu_torch.io_.jpeg.JpegCoefficients`."""
    return DecodeGeometry(
        width=co.width, height=co.height, ncomps=co.num_components,
        comps=tuple((c.h_samp, c.v_samp, c.coefs.shape[1], c.coefs.shape[0])
                    for c in co.components),
        max_h=co.max_h, max_v=co.max_v,
        color=co.color_space if co.num_components == 4 else 3)


def gray_geometry(geo: DecodeGeometry) -> DecodeGeometry:
    """The 1-component view of a colour stream's geometry: libjpeg's
    ``JCS_GRAYSCALE`` decode of a YCbCr stream runs no chroma IDCT and
    copies the range-limited luma, which is the 1-component decode of
    component 0. Only for streams whose luma is at full resolution."""
    h_samp, v_samp, wb, hb = geo.comps[0]
    if (h_samp, v_samp) != (geo.max_h, geo.max_v):
        raise ValueError(f"gray_geometry needs full-resolution luma, got {geo.comps}")
    return DecodeGeometry(width=geo.width, height=geo.height, ncomps=1,
                          comps=((h_samp, v_samp, wb, hb),), max_h=h_samp, max_v=v_samp)


def supported(geo: DecodeGeometry) -> bool:
    """True if the geometry decodes on the card: grayscale; 3 components
    with luma at full resolution and integer chroma ratios (4:4:4, 4:2:2,
    4:2:0, 4:4:0, 4:1:1, 4:1:0, 3:1:1, mismatched Cb/Cr); Adobe CMYK or YCCK
    with integer ratios. Fractional ratios and subsampled luma go to the
    host codec, as in ``hipe_tpu``."""
    if geo.ncomps == 1:
        return True
    if geo.ncomps == 4:
        return geo.color in (4, 5) and not any(
            geo.max_h % h or geo.max_v % v for h, v, _, _ in geo.comps)
    if geo.ncomps != 3 or geo.comps[0][:2] != (geo.max_h, geo.max_v):
        return False
    return not any(geo.max_h % h or geo.max_v % v for h, v, _, _ in geo.comps[1:])


# Scale denominator -> the luma's scaled DCT size (libjpeg's min_DCT_scaled_size).
_MIN_SCALED = {1: 8, 2: 4, 4: 2, 8: 1}


def scaled_sizes(geo: DecodeGeometry, scale_denom: int) -> tuple[int, ...]:
    """Each component's scaled DCT size at 1/scale_denom, as jdmaster.c
    picks it: from 8/scale_denom, doubled while the component's sampling
    ratio absorbs it. So 4:2:0 chroma comes out at the output's resolution,
    while 4:2:2 and 4:4:0 chroma keep a 2x upsample along one axis."""
    mins = _MIN_SCALED[scale_denom]
    sizes = []
    for h_samp, v_samp, _, _ in geo.comps:
        ssize = mins
        while (ssize < 8 and (geo.max_h * mins) % (h_samp * ssize * 2) == 0
               and (geo.max_v * mins) % (v_samp * ssize * 2) == 0):
            ssize *= 2
        sizes.append(ssize)
    return tuple(sizes)


def _scaled_down_dims(geo: DecodeGeometry, ci: int, ssize: int) -> tuple[int, int]:
    """A component's sample dims at scaled DCT size ``ssize`` (jdmaster.c)."""
    h_samp, v_samp, _, _ = geo.comps[ci]
    return (-(-geo.height * v_samp * ssize // (geo.max_v * 8)),
            -(-geo.width * h_samp * ssize // (geo.max_h * 8)))


def supported_scaled(geo: DecodeGeometry, scale_denom: int) -> bool:
    """True if a 1/scale_denom decode runs on the card (else the host's)."""
    if scale_denom == 1:
        return supported(geo)
    if scale_denom not in (2, 4, 8) or not supported(geo):
        return False
    sizes = scaled_sizes(geo, scale_denom)
    mins = _MIN_SCALED[scale_denom]
    # A fractional scaled ratio goes to the host.
    return not any((geo.max_h * mins) % (h * ss) or (geo.max_v * mins) % (v * ss)
                   for (h, v, _, _), ss in zip(geo.comps, sizes))


def _flat(coefs: torch.Tensor) -> torch.Tensor:
    """(..., Hb, Wb, 64) -> a contiguous (B, Hb, Wb, 64)."""
    return coefs.reshape(-1, *coefs.shape[-3:]).contiguous()


def _scaled_grid(coefs: torch.Tensor, qtable, ssize: int) -> torch.Tensor:
    """(B, Hb, Wb, 64) coefficients -> (B, Hb*ssize, Wb*ssize) uint8 samples
    at scaled DCT size ``ssize``: K6 at 8, the reduced IDCTs (torch ops, in
    batch chunks) below it."""
    if ssize == 8:
        return dequant_idct_cuda(coefs, qtable)
    b, hb, wb, _ = coefs.shape
    out = torch.empty((b, hb * ssize, wb * ssize), dtype=torch.uint8, device=coefs.device)
    for s in _chunks(b, hb * wb * 64):
        out[s] = _grid_from_planes(_idct_planes_reduced(_dequant_planes(coefs[s], qtable),
                                                        ssize))
    return out


def _rows_from_grids(geo: DecodeGeometry, grids: list, scale_denom: int = 1,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The components' sample grids ``(B, ...)`` uint8 at a 1/scale_denom
    decode -> interleaved rows ``(B, H', W'*C)`` uint8: through K11's
    wrapper where :func:`ycc_rows_fancy` takes the geometry; else in batch
    chunks, each grid cropped to its downsampled dims and upsampled by its
    own ratio (:func:`_upsampled`), then colour-converted (YCbCr -> RGB, or
    CMYK/YCCK). ``hipe_tpu`` splits the 4:2:0/4:2:2/4:4:0 layouts into
    phase grids to suit the TPU's lanes; the integers are the same."""
    sizes, mins = scaled_sizes(geo, scale_denom), _MIN_SCALED[scale_denom]
    out_h, out_w = -(-geo.height // scale_denom), -(-geo.width // scale_denom)
    fancy = ycc_rows_fancy(geo, scale_denom)
    if fancy is not None:
        return ycc_rows_cuda(*grids, fancy, _scaled_down_dims(geo, 1, sizes[1]),
                             (out_h, out_w), out=out)
    b, c = grids[0].shape[0], geo.ncomps
    if out is None:
        out = torch.empty((b, out_h, out_w * c), dtype=torch.uint8, device=grids[0].device)
    for s in _chunks(b, out_h * out_w):
        comps = _upsampled(geo, grids, s, sizes, mins, out_h, out_w)
        out[s] = (comps[0] if c == 1 else _cmyk_rows(comps, geo.color) if c == 4
                  else _rgb_rows(*comps))
    return out


def decode_planes(geo: DecodeGeometry, comp_coefs: list, qtables: list,
                  layout: str = "hwc") -> torch.Tensor:
    """Finish decoding on the tensors' device: coefficients -> uint8 pixels.

    ``comp_coefs[i]``: (..., Hb_i, Wb_i, 64) int16 quantized coefficients of
    component i, ``qtables[i]`` its (64,) quant table; leading batch dims
    carry through. ``layout="hwc"`` returns (..., H, W, C), ``"rows"``
    (..., H, W*C), the interleaved rows ``Pipeline.apply_rows`` takes. On a
    CUDA tensor each component's dequantize + IDCT is one K6 launch.
    ``hipe_tpu`` runs the four IDCTs of a CMYK/YCCK stream as one graph;
    K6 computes the same function a block, so the integers are the same.
    """
    return decode_planes_scaled(geo, comp_coefs, qtables, 1, layout)


def decode_planes_scaled(geo: DecodeGeometry, comp_coefs: list, qtables: list,
                         scale_denom: int, layout: str = "hwc") -> torch.Tensor:
    """Decode at 1/scale_denom (1, 2, 4 or 8), libjpeg's DCT-domain scaled
    decode bit for bit (jdmaster.c and jidctred.c): each component runs the
    IDCT of the scaled size libjpeg picks (:func:`scaled_sizes`; K6 where it
    is 8, as for 4:2:0 chroma at 1/2), then chroma whose size could not
    absorb its sampling ratio (4:2:2, 4:4:0) is upsampled at the scaled
    resolution, as jdsample.c does. Output dims are ceil(dim/scale_denom);
    arguments and layouts as :func:`decode_planes`. The IDCTs are one
    ``codec.idct`` span, upsampling and colour one ``codec.upsample_color``
    span, each with the device time of all its launches or chunks."""
    if layout not in ("hwc", "rows"):
        raise ValueError(f"layout must be 'hwc' or 'rows', got {layout!r}")
    if not supported_scaled(geo, scale_denom):
        raise ValueError(f"unsupported sampling geometry: {geo.comps} at 1/{scale_denom}")
    lead = comp_coefs[0].shape[:-3]
    with span("codec.idct", comp_coefs[0].device):
        grids = [_scaled_grid(_flat(c), q, ss)
                 for c, q, ss in zip(comp_coefs, qtables, scaled_sizes(geo, scale_denom))]
    with span("codec.upsample_color", grids[0].device):
        rows = _rows_from_grids(geo, grids, scale_denom)
    h, w = rows.shape[1], rows.shape[2] // geo.ncomps
    return rows.reshape(*lead, h, w * geo.ncomps) if layout == "rows" else \
        rows.reshape(*lead, h, w, geo.ncomps)


def decode_coefficients(co, device=None) -> torch.Tensor:
    """Decode a :class:`hipe_tpu_torch.io_.jpeg.JpegCoefficients` on the
    card (``device``, default ``cuda``) -> (H, W, C) uint8."""
    return decode_coefficients_scaled(co, 1, device)


def decode_coefficients_scaled(co, scale_denom: int, device=None) -> torch.Tensor:
    """:func:`decode_coefficients` at 1/scale_denom -> (ceil(H/scale_denom),
    ceil(W/scale_denom), C) uint8."""
    dev = torch.device("cuda" if device is None else device)
    coefs = [torch.from_numpy(c.coefs).to(dev) for c in co.components]
    return decode_planes_scaled(geometry_of(co), coefs, [c.qtable for c in co.components],
                                scale_denom)


def make_batch_decoder(geo: DecodeGeometry, qtables: list):
    """A (B, ...) batch decoder for one geometry and set of quant tables:
    ``fn(*comp_coefs) -> (B, H, W, C)`` uint8, for device-resident
    coefficient streams (the decode analog of the device stream)."""
    tables = [quant_table(q) for q in qtables]

    def run(*comp_coefs):
        return decode_planes(geo, list(comp_coefs), tables)

    return run
