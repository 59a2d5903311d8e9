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
conversion are plain PyTorch on the card, as ``hipe_tpu`` does them in XLA
ops, in chunks of :data:`CHUNK_PIXELS` output pixels so their int32
temporaries stay small. The plain IDCT below (:func:`_dequant_planes`,
:func:`_idct_planes_core`) is K6's plain version: the CPU path and the
yardstick the kernel is held against.

Still to be ported (ROADMAP.md): scaled decode, grayscale decode of colour
streams and 4-component (CMYK/YCCK) streams.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hipe_tpu_torch.ops.cuda_dct import dequant_idct_cuda, quant_table

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


def _grid_from_planes(blocks: torch.Tensor) -> torch.Tensor:
    """(..., Hb, Wb, 8, 8) blocks -> the (..., Hb*8, Wb*8) sample grid."""
    *lead, hb, wb, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, hb * 8, wb * 8)


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


def _decode_rgb_rows_from_planes(geo: "DecodeGeometry", grids: list,
                                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The three components' sample grids ``(B, Hb_i*8, Wb_i*8)`` uint8 ->
    interleaved RGB rows ``(B, H, W*3)`` uint8, in batch chunks.

    Each chroma grid is cropped to its downsampled size, upsampled by its
    own ratio (:func:`upsample_component`, int16) and colour-converted with
    the cropped luma. ``hipe_tpu`` splits the 4:2:0/4:2:2/4:4:0 layouts into
    phase grids to suit the TPU's lanes; the integers are the same.
    """
    hgt, wid = geo.height, geo.width
    b = grids[0].shape[0]
    if out is None:
        out = torch.empty((b, hgt, wid * 3), dtype=torch.uint8, device=grids[0].device)
    ratios, dims = [], []
    for ci in (1, 2):
        h_samp, v_samp, _, _ = geo.comps[ci]
        ratios.append((geo.max_h // h_samp, geo.max_v // v_samp))
        dims.append(_downsampled_dims(geo, ci))
    for s in _chunks(b, hgt * wid):
        chroma = [upsample_component(grids[ci][s, :dh, :dw], hr, vr)[..., :hgt, :wid]
                  for ci, (hr, vr), (dh, dw) in zip((1, 2), ratios, dims)]
        out[s] = _rgb_rows(grids[0][s, :hgt, :wid], *chroma)
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


def _downsampled_dims(geo: DecodeGeometry, ci: int) -> tuple[int, int]:
    """A component's real sample dims (jdmaster.c downsampled_width/height)."""
    h_samp, v_samp, _, _ = geo.comps[ci]
    return -(-geo.height * v_samp // geo.max_v), -(-geo.width * h_samp // geo.max_h)


def supported(geo: DecodeGeometry) -> bool:
    """True if the geometry decodes on the card: grayscale, and 3 components
    with luma at full resolution and integer chroma ratios (4:4:4, 4:2:2,
    4:2:0, 4:4:0, 4:1:1, 4:1:0, 3:1:1, mismatched Cb/Cr). Fractional ratios
    and subsampled luma go to the host codec, as in ``hipe_tpu``;
    4-component streams are not ported yet (ROADMAP.md)."""
    if geo.ncomps == 1:
        return True
    if geo.ncomps != 3 or geo.comps[0][:2] != (geo.max_h, geo.max_v):
        return False
    return not any(geo.max_h % h or geo.max_v % v for h, v, _, _ in geo.comps[1:])


def decode_planes(geo: DecodeGeometry, comp_coefs: list, qtables: list,
                  layout: str = "hwc") -> torch.Tensor:
    """Finish decoding on the tensors' device: coefficients -> uint8 pixels.

    ``comp_coefs[i]``: (..., Hb_i, Wb_i, 64) int16 quantized coefficients of
    component i, ``qtables[i]`` its (64,) quant table; leading batch dims
    carry through. ``layout="hwc"`` returns (..., H, W, C), ``"rows"``
    (..., H, W*C), the interleaved rows ``Pipeline.apply_rows`` takes. On a
    CUDA tensor each component's dequantize + IDCT is one K6 launch.
    """
    if layout not in ("hwc", "rows"):
        raise ValueError(f"layout must be 'hwc' or 'rows', got {layout!r}")
    if geo.ncomps == 4:
        raise ValueError("4-component (CMYK/YCCK) device decode is not ported yet; "
                         "ROADMAP.md lists it")
    if not supported(geo):
        raise ValueError(f"unsupported sampling geometry: {geo.comps}")
    lead = comp_coefs[0].shape[:-3]
    grids = [dequant_idct_cuda(c.reshape(-1, *c.shape[-3:]).contiguous(), q)
             for c, q in zip(comp_coefs, qtables)]
    c = geo.ncomps
    if c == 1:
        rows = grids[0][:, :geo.height, :geo.width]
    else:
        rows = _decode_rgb_rows_from_planes(geo, grids)
    rows = rows.reshape(*lead, geo.height, geo.width * c)
    return rows if layout == "rows" else rows.reshape(*lead, geo.height, geo.width, c)


def decode_coefficients(co, device=None) -> torch.Tensor:
    """Decode a :class:`hipe_tpu_torch.io_.jpeg.JpegCoefficients` on the
    card (``device``, default ``cuda``) -> (H, W, C) uint8."""
    dev = torch.device("cuda" if device is None else device)
    coefs = [torch.from_numpy(c.coefs).to(dev) for c in co.components]
    return decode_planes(geometry_of(co), coefs, [c.qtable for c in co.components])


def make_batch_decoder(geo: DecodeGeometry, qtables: list):
    """A (B, ...) batch decoder for one geometry and set of quant tables:
    ``fn(*comp_coefs) -> (B, H, W, C)`` uint8, for device-resident
    coefficient streams (the decode analog of the device stream)."""
    tables = [quant_table(q) for q in qtables]

    def run(*comp_coefs):
        return decode_planes(geo, list(comp_coefs), tables)

    return run
