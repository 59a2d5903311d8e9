"""Device-side JPEG encode: colour convert + downsample + fDCT + quantize.

The counterpart of ``hipe_tpu.ops.jpeg_encode``: fixed-point RGB -> YCbCr
(jccolor.c), iMCU edge padding (jcprepct.c, jcsample.c), chroma
downsampling (jcsample.c h2v2/h2v1 with the alternating rounding bias, and
int_downsample for every other ratio), the islow fDCT (jcfdctint.c) and the
round-half-away quantizer (jcdct.c, divisors ``q << 3``). The host does only
the entropy encode (:func:`hipe_tpu_torch.io_.jpeg.write_coefficients`), and
for the same pixels, quality and layout the file is byte-identical to a
direct libjpeg encode.

On a CUDA tensor each component's fDCT + quantize is kernel K7
(:func:`hipe_tpu_torch.ops.cuda_dct.fdct_quantize_cuda`), one launch a
component, from the component's padded uint8 sample grid. Colour
conversion, padding and downsampling are plain PyTorch, in batch chunks of
:data:`~hipe_tpu_torch.ops.jpeg_decode.CHUNK_PIXELS` input pixels.
:func:`fdct_quantize_plain` is K7's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from hipe_tpu_torch.io_ import jpeg as jio
from hipe_tpu_torch.ops.cuda_dct import fdct_quantize_cuda, quant_table
from hipe_tpu_torch.ops.jpeg_decode import (
    _F_0_298631336,
    _F_0_390180644,
    _F_0_541196100,
    _F_0_765366865,
    _F_0_899976223,
    _F_1_175875602,
    _F_1_501321110,
    _F_1_847759065,
    _F_1_961570560,
    _F_2_053119869,
    _F_2_562915447,
    _F_3_072711026,
    _ONE_HALF,
    _SCALEBITS,
    CONST_BITS,
    PASS1_BITS,
    DecodeGeometry,
    _chunks,
    _descale,
    _fix,
)
from hipe_tpu_torch.profiling.trace import span

# jccolor.c rgb_ycc tables.
_FIX_0_29900 = _fix(0.29900)
_FIX_0_58700 = _fix(0.58700)
_FIX_0_11400 = _fix(0.11400)
_FIX_0_16874 = _fix(0.16874)
_FIX_0_33126 = _fix(0.33126)
_FIX_0_50000 = _fix(0.50000)
_FIX_0_41869 = _fix(0.41869)
_FIX_0_08131 = _fix(0.08131)
_CBCR_OFFSET = 128 << _SCALEBITS


def rgb_to_ycc(rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-point RGB -> YCbCr, bit-exact vs jccolor.c rgb_ycc_convert:
    (..., H, W, 3) uint8 -> three (..., H, W) int32 planes in [0, 255]."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    y = (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b + _ONE_HALF) >> _SCALEBITS
    cb = (-_FIX_0_16874 * r - _FIX_0_33126 * g + _FIX_0_50000 * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_FIX_0_50000 * r - _FIX_0_41869 * g - _FIX_0_08131 * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    return y, cb, cr


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Fixed-point RGB -> luma, bit-exact vs jccolor.c rgb_gray_convert (the
    Y of :func:`rgb_to_ycc`): (..., H, W, 3) uint8 -> (..., H, W) int32."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    return (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b + _ONE_HALF) >> _SCALEBITS


def _pad_edge(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge-replicate the trailing (h, w) dims up to (rows, cols): the
    compressor's iMCU-edge expansion (last-sample duplication)."""
    dh, dw = rows - x.shape[-2], cols - x.shape[-1]
    if dh > 0:
        x = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], dh, x.shape[-1])], dim=-2)
    if dw > 0:
        x = torch.cat([x, x[..., :, -1:].expand(*x.shape[:-1], dw)], dim=-1)
    return x


def _alternating_bias(w: int, even: int, odd: int, device) -> torch.Tensor:
    """jcsample.c's rounding bias by output-column parity, as a row vector
    (made on the device: no host-to-device copy a call)."""
    if w % 2:
        raise ValueError(f"the downsampled width {w} must be even")
    return torch.arange(w, dtype=torch.int32, device=device) % 2 * (odd - even) + even


def downsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """2x2 average, bit-exact vs jcsample.c h2v2_downsample (bias 1, 2, 1,
    2 by output column): (..., 2h, 2w) int32 -> (..., h, w)."""
    h2, w2 = plane.shape[-2] // 2, plane.shape[-1] // 2
    s = plane.reshape(*plane.shape[:-2], h2, 2, w2, 2).sum(dim=(-3, -1), dtype=torch.int32)
    return (s + _alternating_bias(w2, 1, 2, plane.device)) >> 2


def downsample_h2v1(plane: torch.Tensor) -> torch.Tensor:
    """2x1 average, bit-exact vs jcsample.c h2v1_downsample (bias 0, 1)."""
    w2 = plane.shape[-1] // 2
    s = plane.reshape(*plane.shape[:-1], w2, 2).sum(dim=-1, dtype=torch.int32)
    return (s + _alternating_bias(w2, 0, 1, plane.device)) >> 1


def downsample_int(plane: torch.Tensor, h_expand: int, v_expand: int) -> torch.Tensor:
    """jcsample.c int_downsample: the block average with a fixed
    ``numpix / 2`` bias and truncating division, libjpeg's method for every
    other ratio (4:1:1, 4:1:0, 3:1:1, mismatched chroma)."""
    hh, ww = plane.shape[-2] // v_expand, plane.shape[-1] // h_expand
    s = plane.reshape(*plane.shape[:-2], hh, v_expand, ww, h_expand).sum(
        dim=(-3, -1), dtype=torch.int32)
    numpix = h_expand * v_expand
    return (s + numpix // 2) // numpix


def _fdct_1d(d: list, final: bool) -> list:
    """One 8-point islow forward-DCT pass over 8 int32 tensors (jcfdctint.c)."""
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out = [None] * 8
    if not final:
        out[0] = (t10 + t11) << PASS1_BITS
        out[4] = (t10 - t11) << PASS1_BITS
        shift = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(t10 + t11, PASS1_BITS)
        out[4] = _descale(t10 - t11, PASS1_BITS)
        shift = CONST_BITS + PASS1_BITS
    z1 = (t12 + t13) * _F_0_541196100
    out[2] = _descale(z1 + t13 * _F_0_765366865, shift)
    out[6] = _descale(z1 - t12 * _F_1_847759065, shift)
    z1 = t4 + t7
    z2 = t5 + t6
    z3 = t4 + t6
    z4 = t5 + t7
    z5 = (z3 + z4) * _F_1_175875602
    t4 = t4 * _F_0_298631336
    t5 = t5 * _F_2_053119869
    t6 = t6 * _F_3_072711026
    t7 = t7 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5
    out[7] = _descale(t4 + z1 + z3, shift)
    out[5] = _descale(t5 + z2 + z4, shift)
    out[3] = _descale(t6 + z2 + z3, shift)
    out[1] = _descale(t7 + z1 + z4, shift)
    return out


def _planes_from_grid(grid: torch.Tensor) -> torch.Tensor:
    """(..., Hb*8, Wb*8) samples -> (..., Hb, Wb, 8, 8) blocks; the inverse
    of :func:`hipe_tpu_torch.ops.jpeg_decode._grid_from_planes`."""
    *lead, h, w = grid.shape
    return grid.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)


def _fdct_planes_core(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) level-shifted int32 blocks -> unquantized fDCT blocks.

    Row pass (each row walks its columns), then column pass: jcfdctint.c's
    order, the mirror of the IDCT's.
    """
    ws = torch.stack(_fdct_1d([blocks[..., :, c] for c in range(8)], final=False), dim=-1)
    return torch.stack(_fdct_1d([ws[..., r, :] for r in range(8)], final=True), dim=-2)


def fdct_quantize_plain(grid: torch.Tensor, qtable) -> torch.Tensor:
    """Level shift + fDCT + quantize in plain PyTorch (K7's plain version).

    ``grid``: (..., Hb*8, Wb*8) samples in [0, 255]; returns (..., Hb, Wb,
    64) int16 natural-order coefficients: divisors ``q << 3`` (jcdct.c
    start_pass_fdctmgr), round half away from zero (forward_DCT).
    """
    t = _fdct_planes_core(_planes_from_grid(grid.to(torch.int32) - 128))
    qd = torch.from_numpy(quant_table(qtable).astype(np.int32) << 3).to(grid.device)
    t = t.reshape(*t.shape[:-2], 64)
    v = (t.abs() + (qd >> 1)) // qd
    return torch.where(t < 0, -v, v).to(torch.int16)


def fdct_quantize(grid: torch.Tensor, qtable) -> torch.Tensor:
    """Padded sample grid ``(..., Hb*8, Wb*8)`` -> quantized coefficients
    ``(..., Hb, Wb, 64)`` int16, exactly what libjpeg would store for these
    samples. On a CUDA tensor this is K7."""
    *lead, h, w = grid.shape
    out = fdct_quantize_cuda(grid.reshape(-1, h, w).to(torch.uint8).contiguous(), qtable)
    return out.reshape(*lead, h // 8, w // 8, 64)


# Chroma layouts the device encoder implements: the four libjpeg defaults
# through the alternating-bias downsamplers, every other integer ratio
# through int_downsample, as jcsample.c start_pass_downsample selects.
DEVICE_SUBSAMPLINGS = ("420", "444", "422", "440", "411", "410", "311", "asym")
# Per-component (h_samp, v_samp): the native codec's apply_subsamp table, so
# the device encoder's geometry is the host writer's.
_SUBSAMP_COMPS = jio._SUB_FACTORS


def encode_geometry(height: int, width: int, channels: int,
                    subsampling: str = "420") -> DecodeGeometry:
    """Component geometry of an encode, matching jpeg_set_defaults."""
    if channels == 1:
        return DecodeGeometry(width=width, height=height, ncomps=1,
                              comps=((1, 1, -(-width // 8), -(-height // 8)),),
                              max_h=1, max_v=1)
    facs = _SUBSAMP_COMPS[subsampling]
    max_h = max(f[0] for f in facs)
    max_v = max(f[1] for f in facs)
    comps = []
    for h_i, v_i in facs:
        dw = -(-width * h_i // max_h)
        dh = -(-height * v_i // max_v)
        comps.append((h_i, v_i, -(-dw // 8), -(-dh // 8)))
    return DecodeGeometry(width=width, height=height, ncomps=3, comps=tuple(comps),
                          max_h=max_h, max_v=max_v)


def _sample_grids(geo: DecodeGeometry, img: torch.Tensor) -> list[torch.Tensor]:
    """(B, H, W, 3) or (B, H, W) uint8 pixels -> each component's padded
    sample grid (B, Hb_i*8, Wb_i*8) uint8, in batch chunks.

    The direct encoder's edge semantics: horizontally the downsampler's
    input is expanded to output_cols * h_expand (jcsample.c
    expand_right_edge); vertically full-resolution rows are expanded only to
    the conversion group (a multiple of v_samp), and the rest is replicated
    in the downsampled domain (jcprepct.c expand_bottom_edge).
    """
    b = img.shape[0]
    hgt, wid = geo.height, geo.width
    grids = [torch.empty((b, hb * 8, wb * 8), dtype=torch.uint8, device=img.device)
             for _, _, wb, hb in geo.comps]
    if geo.ncomps == 1:
        _, _, wb, hb = geo.comps[0]
        for s in _chunks(b, hgt * wid):
            grids[0][s] = _pad_edge(img[s], hb * 8, wb * 8)
        return grids
    hs, vs = geo.max_h, geo.max_v
    _, _, ywb, yhb = geo.comps[0]
    imcu_w = 8 * hs * -(-wid // (8 * hs))
    group_h = vs * -(-hgt // vs)
    for s in _chunks(b, hgt * wid):
        y, cb, cr = rgb_to_ycc(img[s])
        grids[0][s] = _pad_edge(y, yhb * 8, imcu_w)[..., :, :ywb * 8]
        for ci, plane in ((1, cb), (2, cr)):
            h_i, v_i, wb_i, hb_i = geo.comps[ci]
            h_e, v_e = hs // h_i, vs // v_i
            in_w = wb_i * 8 * h_e
            plane = _pad_edge(plane, group_h, in_w)[..., :, :in_w]
            if (h_e, v_e) == (2, 2):
                plane = downsample_h2v2(plane)
            elif (h_e, v_e) == (2, 1):
                plane = downsample_h2v1(plane)
            elif (h_e, v_e) != (1, 1):
                plane = downsample_int(plane, h_e, v_e)
            grids[ci][s] = _pad_edge(plane, hb_i * 8, wb_i * 8)
    return grids


def encode_planes(geo: DecodeGeometry, img: torch.Tensor, qtables: list) -> list[torch.Tensor]:
    """Device encode: pixels -> per-component quantized coefficients.

    ``img``: (..., H, W, 3) uint8, or (..., H, W) / (..., H, W, 1) for
    grayscale. Returns ``[(..., Hb_i, Wb_i, 64) int16]``, libjpeg's own
    coefficients for the same pixels, quality and layout. On a CUDA tensor
    each component's fDCT + quantize is one K7 launch. Colour conversion,
    padding and downsampling are one ``codec.color_downsample`` span, the
    fDCTs one ``codec.fdct`` span, each with the device time of all its
    chunks or launches.
    """
    hgt, wid = geo.height, geo.width
    if geo.ncomps == 1:
        if tuple(img.shape[-2:]) == (hgt, wid):
            lead = img.shape[:-2]
        elif tuple(img.shape[-3:]) == (hgt, wid, 1):
            lead = img.shape[:-3]
        else:
            raise ValueError(f"bad grayscale shape {tuple(img.shape)}")
        x = img.reshape(-1, hgt, wid)
    else:
        if tuple(img.shape[-3:]) != (hgt, wid, 3):
            raise ValueError(f"expected (..., {hgt}, {wid}, 3) pixels, got {tuple(img.shape)}")
        lead = img.shape[:-3]
        x = img.reshape(-1, hgt, wid, 3)
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 pixels, got {x.dtype}")
    with span("codec.color_downsample", x.device):
        grids = _sample_grids(geo, x)
    with span("codec.fdct", x.device):
        coefs = [fdct_quantize(g, q) for g, q in zip(grids, qtables)]
    return [c.reshape(*lead, *c.shape[1:]) for c in coefs]


def encode_bytes_device(img: np.ndarray, quality: int = 90, subsampling: str = "420",
                        progressive: bool = False, device=None) -> bytes:
    """Encode one HWC uint8 image: colour, downsample, fDCT and quantize on
    the card (``device``, default ``cuda``), the entropy encode on the host.
    Byte-identical to :func:`hipe_tpu_torch.io_.jpeg.encode_bytes_opts`."""
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    geo = encode_geometry(h, w, channels, subsampling)
    luma, chroma = jio.quality_tables(quality)
    qtables = [luma] if channels == 1 else [luma, chroma, chroma]
    x = torch.from_numpy(np.ascontiguousarray(img)).to(
        torch.device("cuda" if device is None else device))
    coefs = [c.cpu().numpy() for c in encode_planes(geo, x, qtables)]
    return jio.write_coefficients(coefs, w, h, quality=quality, subsampling=subsampling,
                                  progressive=progressive)
