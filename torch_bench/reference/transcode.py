"""Reference of ``transcode``: libjpeg's integer decode, the reference
program's 3x3 blur, libjpeg's integer encode, for 4:2:0 YCbCr sets.

Written from libjpeg's C, step by step, in int32 (the C's ``INT32``; its
products wrap as the C's do):

- decode: dequantize and ``jpeg_idct_islow`` (jidctint.c) with the
  post-IDCT range-limit table of jdmaster.c's ``prepare_range_limit_table``;
  ``h2v2_fancy_upsample`` (jdsample.c), whose context rows above the image
  and below its last real row repeat the edge row (jdmainct.c), and its
  plain ``h2v2_upsample`` where a chroma plane is 2 samples wide or less;
  ``ycc_rgb_convert`` through jdcolor.c's tables;
- the filter: ``reference/stencils.py``'s ``gaussian3`` a channel;
- encode: ``rgb_ycc_convert`` through jccolor.c's table; the rows of the
  last conversion group repeated (jcprepct.c ``expand_bottom_edge``), the
  columns to the downsampler's width (jcsample.c ``expand_right_edge``),
  ``h2v2_downsample`` with its bias of 1, 2, 1, 2 and ``fullsize_downsample``,
  the rows of the last iMCU repeated in the downsampled domain
  (jcprepct.c); then ``jpeg_fdct_islow`` (jcfdctint.c) after the level shift
  and ``forward_DCT``'s quantizer (jcdctmgr.c: divisors ``q << 3``, round
  half away from zero); the tables are jcparam.c's at the quality.

Any image size libjpeg takes works. A set is three (N, Hb, Wb, 64) int16
tensors in natural order (Y, Cb, Cr), each component's ``height_in_blocks``
by ``width_in_blocks``. ``dtype`` is the filter's arithmetic type, as in the
other references: ``torch.float32`` gives the integers, a narrower type
(the control, ``torch.bfloat16``) does not. The codec's stages are integer
whatever ``dtype``.
"""

from __future__ import annotations

import torch

from reference.stencils import gaussian3

# jcparam.c std_luminance_quant_tbl and std_chrominance_quant_tbl, natural
# order (the JPEG standard's tables K.1 and K.2).
STD_LUMA = (16, 11, 10, 16, 24, 40, 51, 61,
            12, 12, 14, 19, 26, 58, 60, 55,
            14, 13, 16, 24, 40, 57, 69, 56,
            14, 17, 22, 29, 51, 87, 80, 62,
            18, 22, 37, 56, 68, 109, 103, 77,
            24, 35, 55, 64, 81, 104, 113, 92,
            49, 64, 78, 87, 103, 121, 120, 101,
            72, 92, 95, 98, 112, 100, 103, 99)
STD_CHROMA = (17, 18, 24, 47) + (99,) * 4 + (18, 21, 26, 66) + (99,) * 4 + \
    (24, 26, 56) + (99,) * 5 + (47, 66) + (99,) * 6 + (99,) * 32

CONST_BITS, PASS1_BITS = 13, 2
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
CENTERJSAMPLE = 128


def _fix13(x: float) -> int:
    """jidctint.c's / jcfdctint.c's FIX(x) at CONST_BITS 13."""
    return int(x * (1 << CONST_BITS) + 0.5)


def _fix16(x: float) -> int:
    """jdcolor.c's / jccolor.c's FIX(x) at SCALEBITS 16."""
    return int(x * (1 << SCALEBITS) + 0.5)


F = {name: _fix13(v) for name, v in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def quant_tables(quality: int) -> tuple[list[int], list[int]]:
    """jcparam.c's ``jpeg_set_quality`` with ``force_baseline``: (luma,
    chroma), natural order."""
    q = min(max(quality, 1), 100)
    scale = 5000 // q if q < 50 else 200 - q * 2

    def scaled(base):
        return [min(max((b * scale + 50) // 100, 1), 255) for b in base]

    return scaled(STD_LUMA), scaled(STD_CHROMA)


def block_dims(height: int, width: int) -> list[tuple[int, int]]:
    """Each component's (height_in_blocks, width_in_blocks) at 4:2:0
    (jcmaster.c / jdinput.c: ceil(dim * samp / (max_samp * 8)))."""
    luma = (-(-height // 8), -(-width // 8))
    chroma = (-(-height // 16), -(-width // 16))
    return [luma, chroma, chroma]


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """jpegint.h's DESCALE: add half, arithmetic shift right."""
    return (x + (1 << (n - 1))) >> n


def _idct_1d(v: torch.Tensor, pass1: bool) -> torch.Tensor:
    """One pass of ``jpeg_idct_islow`` along the last axis (8 entries):
    pass 1 over the columns (descale by CONST_BITS - PASS1_BITS), pass 2
    over the rows (by CONST_BITS + PASS1_BITS + 3). A pass with only a DC
    term (the C's shortcut) gives what the full pass gives."""
    d = [v[..., k] for k in range(8)]
    # Even part.
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * F["0_541196100"]
    tmp2 = z1 + z3 * (-F["1_847759065"])
    tmp3 = z1 + z2 * F["0_765366865"]
    tmp0 = (d[0] + d[4]) << CONST_BITS
    tmp1 = (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    # Odd part.
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F["1_175875602"]
    t0 = t0 * F["0_298631336"]
    t1 = t1 * F["2_053119869"]
    t2 = t2 * F["3_072711026"]
    t3 = t3 * F["1_501321110"]
    z1 = z1 * (-F["0_899976223"])
    z2 = z2 * (-F["2_562915447"])
    z3 = z3 * (-F["1_961570560"]) + z5
    z4 = z4 * (-F["0_390180644"]) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    n = CONST_BITS - PASS1_BITS if pass1 else CONST_BITS + PASS1_BITS + 3
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return torch.stack([_descale(o, n) for o in out], dim=-1)


def _idct_range_table(device) -> torch.Tensor:
    """jdmaster.c's post-IDCT range limit, indexed by ``x & 1023``: the
    sample table shifted by CENTERJSAMPLE (x + 128 up to 255), then 255, then
    0, then the table's first 128 entries again."""
    x = torch.arange(1024, dtype=torch.int32, device=device)
    return torch.where(x < 128, x + 128, torch.where(
        x < 512, torch.full_like(x, 255), torch.where(x < 896, torch.zeros_like(x), x - 896)))


def _idct_component(coefs: torch.Tensor, qtable: list[int]) -> torch.Tensor:
    """(N, Hb, Wb, 64) int16 -> the (N, Hb*8, Wb*8) uint8 sample grid."""
    n, hb, wb, _ = coefs.shape
    q = torch.tensor(qtable, dtype=torch.int32, device=coefs.device)
    blocks = (coefs.to(torch.int32) * q).view(n, hb, wb, 8, 8)  # [row][col]
    ws = _idct_1d(blocks.transpose(-1, -2), pass1=True).transpose(-1, -2)
    out = _idct_1d(ws, pass1=False)
    samples = _idct_range_table(coefs.device)[(out & 1023).long()]
    return samples.permute(0, 1, 3, 2, 4).reshape(n, hb * 8, wb * 8)


def _edge_index(size: int, shift: int, device) -> torch.Tensor:
    """Indices ``0 .. size - 1`` moved by ``shift``, held at the edges."""
    return (torch.arange(size, device=device) + shift).clamp(0, size - 1)


def _upsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """jdsample.c's ``h2v2_fancy_upsample`` of a (N, h, w) plane of real
    samples -> (N, 2h, 2w) int32. Output row 2i weighs input row i by 3 and
    the row above by 1, row 2i + 1 the row below; then output column 2j
    weighs those column sums by 3 and the column to the left by 1, + 8,
    column 2j + 1 the column to the right, + 7; >> 4. Rows and columns past
    the edges repeat the edge. Where the plane is 2 samples wide or less,
    ``h2v2_upsample``: each sample copied 2 x 2."""
    x = plane.to(torch.int32)
    n, h, w = x.shape
    if w <= 2:
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    up = x[:, _edge_index(h, -1, x.device)]
    down = x[:, _edge_index(h, 1, x.device)]
    rows = torch.stack([3 * x + up, 3 * x + down], dim=2).reshape(n, 2 * h, w)
    left = rows[:, :, _edge_index(w, -1, x.device)]
    right = rows[:, :, _edge_index(w, 1, x.device)]
    return torch.stack([(3 * rows + left + 8) >> 4, (3 * rows + right + 7) >> 4],
                       dim=3).reshape(n, 2 * h, 2 * w)


def _ycc_rgb_tables(device):
    """jdcolor.c's ``build_ycc_rgb_table``: Cr_r, Cb_b, Cr_g, Cb_g over the
    256 sample values."""
    x = torch.arange(256, dtype=torch.int32, device=device) - CENTERJSAMPLE
    cr_r = (_fix16(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix16(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


def decode(coefs: list, height: int, width: int, quality: int = 90) -> torch.Tensor:
    """Three components' coefficients -> (N, height, width, 3) uint8 RGB."""
    luma_q, chroma_q = quant_tables(quality)
    grids = [_idct_component(c, q) for c, q in zip(coefs, (luma_q, chroma_q, chroma_q))]
    ch, cw = -(-height // 2), -(-width // 2)
    y = grids[0][:, :height, :width].to(torch.int32)
    cb, cr = (_upsample_h2v2(g[:, :ch, :cw])[:, :height, :width] for g in grids[1:])
    cr_r, cb_b, cr_g, cb_g = _ycc_rgb_tables(y.device)
    cb, cr = cb.long(), cr.long()
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)
    b = y + cb_b[cb]
    # jdcolor.c's range_limit: the sample table, 0 below and 255 above.
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def _rgb_ycc_table(device) -> torch.Tensor:
    """jccolor.c's ``rgb_ycc_start``: (8, 256) int32, in the C's order
    R_Y, G_Y, B_Y, R_CB, G_CB, B_CB (= R_CR), G_CR, B_CR."""
    i = torch.arange(256, dtype=torch.int32, device=device)
    half = (CENTERJSAMPLE << SCALEBITS) + ONE_HALF - 1
    return torch.stack([
        _fix16(0.29900) * i, _fix16(0.58700) * i, _fix16(0.11400) * i + ONE_HALF,
        -_fix16(0.16874) * i, -_fix16(0.33126) * i, _fix16(0.50000) * i + half,
        -_fix16(0.41869) * i, -_fix16(0.08131) * i])


def _expand(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(N, h, w) -> (N, rows, cols), the last row and column repeated
    (jcsample.c ``expand_right_edge``, jcprepct.c ``expand_bottom_edge``)."""
    _, h, w = x.shape
    ri = torch.arange(rows, device=x.device).clamp(max=h - 1)
    ci = torch.arange(cols, device=x.device).clamp(max=w - 1)
    return x[:, ri][:, :, ci]


def _h2v2_downsample(x: torch.Tensor, out_cols: int) -> torch.Tensor:
    """jcsample.c's ``h2v2_downsample`` of (N, 2m, 2 * out_cols) int32: the
    2 x 2 sums + bias 1, 2, 1, 2, ... by output column, >> 2."""
    s = x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]
    bias = 1 + torch.arange(out_cols, dtype=torch.int32, device=x.device) % 2
    return (s + bias) >> 2


def _fdct_1d(v: torch.Tensor, pass1: bool) -> torch.Tensor:
    """One pass of ``jpeg_fdct_islow`` along the last axis: pass 1 over the
    rows (DC and 4 scaled up by PASS1_BITS, the rest descaled by CONST_BITS -
    PASS1_BITS), pass 2 over the columns (PASS1_BITS and CONST_BITS +
    PASS1_BITS)."""
    d = [v[..., k] for k in range(8)]
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if pass1:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
        n = CONST_BITS + PASS1_BITS
    z1 = (tmp12 + tmp13) * F["0_541196100"]
    out[2] = _descale(z1 + tmp13 * F["0_765366865"], n)
    out[6] = _descale(z1 + tmp12 * (-F["1_847759065"]), n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F["1_175875602"]
    tmp4 = tmp4 * F["0_298631336"]
    tmp5 = tmp5 * F["2_053119869"]
    tmp6 = tmp6 * F["3_072711026"]
    tmp7 = tmp7 * F["1_501321110"]
    z1 = z1 * (-F["0_899976223"])
    z2 = z2 * (-F["2_562915447"])
    z3 = z3 * (-F["1_961570560"]) + z5
    z4 = z4 * (-F["0_390180644"]) + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return torch.stack(out, dim=-1)


def _fdct_component(grid: torch.Tensor, qtable: list[int]) -> torch.Tensor:
    """(N, Hb*8, Wb*8) samples -> (N, Hb, Wb, 64) int16: the level shift,
    ``jpeg_fdct_islow`` (rows, then columns) and jcdctmgr.c's quantizer."""
    n, h, w = grid.shape
    blocks = (grid.to(torch.int32) - CENTERJSAMPLE).view(n, h // 8, 8, w // 8, 8)
    blocks = blocks.permute(0, 1, 3, 2, 4)  # [row][col] a block
    ws = _fdct_1d(blocks, pass1=True)
    t = _fdct_1d(ws.transpose(-1, -2), pass1=False).transpose(-1, -2)
    t = t.reshape(n, h // 8, w // 8, 64)
    div = torch.tensor(qtable, dtype=torch.int32, device=grid.device) << 3
    mag = (t.abs() + (div >> 1)) // div
    return torch.where(t < 0, -mag, mag).to(torch.int16)


def encode(rgb: torch.Tensor, quality: int = 90) -> list[torch.Tensor]:
    """(N, H, W, 3) uint8 RGB -> the three components' quantized
    coefficients, (N, Hb_i, Wb_i, 64) int16, at 4:2:0 and ``quality``."""
    n, height, width, _ = rgb.shape
    (yh, yw), (ch, cw), _ = block_dims(height, width)
    tab = _rgb_ycc_table(rgb.device)
    r, g, b = (rgb[..., i].long() for i in range(3))
    y = (tab[0][r] + tab[1][g] + tab[2][b]) >> SCALEBITS
    cb = (tab[3][r] + tab[4][g] + tab[5][b]) >> SCALEBITS
    cr = (tab[5][r] + tab[6][g] + tab[7][b]) >> SCALEBITS
    # The conversion groups of 2 rows: the last one's missing row repeats.
    group_rows = 2 * -(-height // 2)
    grids = [_expand(y, yh * 8, yw * 8)]
    for plane in (cb, cr):
        small = _h2v2_downsample(_expand(plane, group_rows, cw * 16), cw * 8)
        grids.append(_expand(small, ch * 8, cw * 8))
    luma_q, chroma_q = quant_tables(quality)
    return [_fdct_component(grid.to(torch.uint8), q)
            for grid, q in zip(grids, (luma_q, chroma_q, chroma_q))]


def apply(coefs: list, height: int, width: int, quality: int = 90,
          dtype=torch.float32) -> list[torch.Tensor]:
    """A transcode: decode, blur3 (in ``dtype``), encode."""
    rgb = decode(coefs, height, width, quality)
    n = rgb.shape[0]
    planes = rgb.permute(0, 3, 1, 2).reshape(n * 3, height, width)
    blurred = gaussian3(planes, dtype).view(n, 3, height, width).permute(0, 2, 3, 1)
    return encode(blurred.contiguous(), quality)
