"""Kernel K11 (``csrc/ycc_rows.cu``: upsample + YCbCr -> RGB rows) off the card.

Which decodes K11 takes (``jpeg_decode.ycc_rows_fancy``) is held against
``_upsampled``'s own choice of upsampler over every geometry the card
decodes at 1/1, 1/2, 1/4 and 1/8; K11's plain version (the wrapper on CPU
tensors, which the CPU decode of those geometries runs) against the torch
loop it stands for; the wrapper's checks; and
the aligned form's unit and store map, restated from the kernel. The kernel
itself runs only on the card (``tests/test_torch_cuda_ycc_rows.py``).
"""

import itertools

import numpy as np
import pytest
import torch

from hipe_tpu_torch.ops import cuda_dct
from hipe_tpu_torch.ops import jpeg_decode as jd

SIZES = [(240, 320), (33, 41), (17, 23), (16, 16), (8, 8), (9, 9)]  # (H, W)


def _geometry(height: int, width: int, samplings, color: int = 3) -> jd.DecodeGeometry:
    """A stream's geometry from its components' (h, v) sampling factors,
    the blocks of each as libjpeg counts them."""
    max_h, max_v = max(h for h, _ in samplings), max(v for _, v in samplings)
    comps = tuple((h, v, -(-width * h // (max_h * 8)), -(-height * v // (max_v * 8)))
                  for h, v in samplings)
    return jd.DecodeGeometry(width=width, height=height, ncomps=len(samplings), comps=comps,
                             max_h=max_h, max_v=max_v, color=color if len(samplings) == 4 else 3)


def _all_geometries(height: int, width: int):
    """Gray; every 3-component sampling with factors 1-4; CMYK and YCCK at
    4:4:4 and libjpeg's YCCK 4:2:0."""
    yield _geometry(height, width, ((1, 1),))
    factors = list(itertools.product((1, 2, 3, 4), repeat=2))
    for samplings in itertools.product(factors, repeat=3):
        yield _geometry(height, width, samplings)
    for color in (4, 5):
        yield _geometry(height, width, ((1, 1),) * 4, color)
        yield _geometry(height, width, ((2, 2), (1, 1), (1, 1), (2, 2)), color)


def _grids(geo, denom, seed=0, kind="random"):
    """(2, rows, pitch) uint8 sample grids at the decode's scaled DCT sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for (_, _, wb, hb), ss in zip(geo.comps, jd.scaled_sizes(geo, denom)):
        shape = (2, hb * ss, wb * ss)
        g = (rng.integers(0, 256, shape) if kind == "random"
             else rng.integers(0, 2, shape) * 255)
        out.append(torch.from_numpy(g.astype(np.uint8)))
    return out


def _upsamplers(geo, denom) -> list[list[str]]:
    """The upsamplers ``_upsampled`` calls on each component, in order."""
    calls = [[] for _ in geo.comps]
    saved = {}

    def recording(name):
        fn = getattr(jd, name)

        def run(plane, *args):
            calls[int(plane.reshape(-1)[0])].append(name)
            return fn(plane, *args)

        return run

    names = ("fancy_upsample_h2v2", "fancy_upsample_h2v1", "fancy_upsample_h1v2", "_replicate")
    for name in names:
        saved[name] = getattr(jd, name)
        setattr(jd, name, recording(name))
    try:
        sizes, mins = jd.scaled_sizes(geo, denom), jd._MIN_SCALED[denom]
        # Component ci's grid holds ci, so a call names its component.
        grids = [torch.full((1, hb * ss, wb * ss), ci, dtype=torch.uint8)
                 for ci, ((_, _, wb, hb), ss) in enumerate(zip(geo.comps, sizes))]
        jd._upsampled(geo, grids, slice(0, 1), sizes, mins, -(-geo.height // denom),
                      -(-geo.width // denom))
    finally:
        for name, fn in saved.items():
            setattr(jd, name, fn)
    return calls


@pytest.mark.parametrize("denom", [1, 2, 4, 8])
@pytest.mark.parametrize("size", SIZES + [(16, 4), (24, 12)], ids=str)
def test_ratio_follows_upsampled_choice(size, denom):
    seen = set()
    for geo in _all_geometries(*size):
        if not jd.supported_scaled(geo, denom):
            continue
        got = jd.ycc_rows_fancy(geo, denom)
        calls = _upsamplers(geo, denom)
        if geo.ncomps != 3:
            want = None
        elif calls[1:] == [[], []]:
            want = False
        elif calls[1:] == [["fancy_upsample_h2v2"]] * 2:
            want = True
        else:
            want = None
        assert calls[0] == [], (geo, calls)
        assert got == want, (geo, denom, calls)
        seen.add(got)
    # Every size and scale meets covered and uncovered geometries.
    assert None in seen and False in seen, seen
    if denom == 1 and size[1] > 4:
        assert True in seen, seen


def test_ratio_of_the_named_geometries():
    s420 = ((2, 2), (1, 1), (1, 1))
    cases = {(s420, 240, 320, 1): True, (s420, 240, 320, 2): False,
             (s420, 240, 320, 4): False, (s420, 240, 320, 8): False,
             (((1, 1),) * 3, 240, 320, 1): False,
             (((2, 1), (1, 1), (1, 1)), 240, 320, 1): None,  # 4:2:2
             (((1, 2), (1, 1), (1, 1)), 240, 320, 1): None,  # 4:4:0
             (((4, 1), (1, 1), (1, 1)), 240, 320, 1): None,  # 4:1:1, replicated
             (((2, 2), (1, 1), (2, 1)), 240, 320, 1): None,  # mismatched chroma
             (s420, 16, 4, 1): None,  # chroma 2 wide: the narrow-plane guard
             (s420, 16, 5, 1): True}
    for (samplings, h, w, denom), want in cases.items():
        assert jd.ycc_rows_fancy(_geometry(h, w, samplings), denom) is want, (samplings, h, w)
    assert jd.ycc_rows_fancy(_geometry(16, 16, ((1, 1),)), 1) is None
    for color in (4, 5):
        assert jd.ycc_rows_fancy(_geometry(16, 16, ((1, 1),) * 4, color), 1) is None


@pytest.mark.parametrize("kind", ["random", "0/255"])
@pytest.mark.parametrize("layout", ["420", "444", "420 at 1/2", "420 at 1/8"])
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_plain_version_equals_the_torch_path(size, layout, kind):
    samplings = ((1, 1),) * 3 if layout == "444" else ((2, 2), (1, 1), (1, 1))
    denom = int(layout.split("/")[1]) if "/" in layout else 1
    geo = _geometry(*size, samplings)
    fancy = jd.ycc_rows_fancy(geo, denom)
    assert fancy is (layout == "420")
    grids = _grids(geo, denom, seed=size[0] * 100 + size[1], kind=kind)
    sizes, mins = jd.scaled_sizes(geo, denom), jd._MIN_SCALED[denom]
    out_dims = (-(-size[0] // denom), -(-size[1] // denom))
    # The torch loop K11 stands for: each plane upsampled by _upsampled's own
    # choice, then colour-converted.
    want = jd._rgb_rows(*jd._upsampled(geo, grids, slice(None), sizes, mins, *out_dims))
    dims = jd._scaled_down_dims(geo, 1, sizes[1])
    assert dims == jd._scaled_down_dims(geo, 2, sizes[2])
    before = cuda_dct.ycc_rows_cuda.launches
    got = cuda_dct.ycc_rows_cuda(*grids, fancy, dims, out_dims)
    assert torch.equal(got, want)
    out = torch.empty_like(want)
    assert cuda_dct.ycc_rows_cuda(*grids, fancy, dims, out_dims, out=out) is out
    assert torch.equal(out, want)
    assert torch.equal(jd._rows_from_grids(geo, grids, denom), want)  # the CPU decode's route
    assert cuda_dct.ycc_rows_cuda.launches == before  # the plain version launches nothing


def test_plain_version_reaches_both_ends_of_the_clamp():
    geo = _geometry(16, 16, ((1, 1),) * 3)
    y, cb, cr = _grids(geo, 1, kind="0/255")
    rows = cuda_dct.ycc_rows_cuda(y, cb, cr, False, (16, 16), (16, 16)).reshape(2, 16, 16, 3)
    for ch in range(3):
        assert rows[..., ch].min() == 0 and rows[..., ch].max() == 255
    # Y 255 with Cr 255 takes R past 255; Y 0 with Cr 0 below 0.
    assert torch.equal(rows[..., 0][(y == 255) & (cr == 255)].unique(), torch.tensor([255],
                                                                                   dtype=torch.uint8))
    assert torch.equal(rows[..., 0][(y == 0) & (cr == 0)].unique(), torch.tensor([0],
                                                                               dtype=torch.uint8))


def _u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


@pytest.mark.parametrize("call", [
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 8, 8).to(torch.int16), _u8(1, 8, 8), _u8(1, 8, 8),
                                   False, (8, 8), (8, 8)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(8, 8), _u8(8, 8), _u8(8, 8), False, (8, 8), (8, 8)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(2, 8, 8), _u8(1, 8, 8), _u8(2, 8, 8), False, (8, 8),
                                   (8, 8)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 8, 16)[:, :, ::2], _u8(1, 8, 8), _u8(1, 8, 8), False,
                                   (8, 8), (8, 8)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 8, 8), _u8(1, 8, 8), _u8(1, 8, 8), False, (8, 8),
                                   (8, 9)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 16, 16), _u8(1, 8, 8), _u8(1, 8, 8), False, (8, 8),
                                   (16, 16)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 16, 16), _u8(1, 8, 8), _u8(1, 8, 8), True, (8, 7),
                                   (16, 16)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 16, 16), _u8(1, 8, 8), _u8(1, 8, 8), True, (9, 8),
                                   (16, 16)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 16, 16), _u8(1, 8, 8), _u8(1, 8, 8), True, (8, 8),
                                   (16, 16), out=_u8(1, 16, 16)),
    lambda: cuda_dct.ycc_rows_cuda(_u8(1, 8, 8), _u8(1, 8, 8), _u8(1, 8, 8), False, (0, 8),
                                   (8, 8)),
], ids=["dtype", "rank", "batch", "strided", "out-wider", "chroma-short", "fancy-narrow",
        "chroma-taller-than-grid", "out-shape", "empty-dims"])
def test_wrapper_raises_before_any_launch(call):
    before = cuda_dct.ycc_rows_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        call()
    assert cuda_dct.ycc_rows_cuda.launches == before


# ---- the aligned form's map, restated from csrc/ycc_rows.cu ----


def _aligned_form_writes(b: int, out_h: int, out_w: int) -> np.ndarray:
    """How often each byte of the (b, out_h, out_w * 3) rows is stored by
    the aligned form: unit u = (b * pairs + i) * runs + k owns the 48 bytes
    at pixel 16k of rows 2i and 2i+1 (if below out_h); warp w's chunk q of
    96 is byte 16 * (q % 3) of unit 32w + q // 3's run."""
    pairs, runs, pitch = (out_h + 1) // 2, out_w // 16, out_w * 3
    units = b * pairs * runs
    count = np.zeros(b * out_h * pitch, np.int64)
    warps = -(-units // 32)
    for w in range(warps):
        dst = []
        for lane in range(32):
            u = 32 * w + lane
            if u >= units:
                dst.append(-1)
                continue
            k, pair = u % runs, u // runs
            img, i = pair // pairs, pair % pairs
            r0 = 2 * i
            dst.append(((img * out_h + r0) * pitch + 48 * k) | int(r0 + 1 < out_h))
        for s in range(3):
            for lane in range(32):
                q = s * 32 + lane
                d = dst[q // 3]
                if d < 0:
                    continue
                o = (d & ~15) + 16 * (q % 3)
                assert o % 16 == 0
                count[o:o + 16] += 1
                if d & 1:
                    count[o + pitch:o + pitch + 16] += 1
    return count


@pytest.mark.parametrize("shape", [(3, 240, 320), (2, 17, 32), (1, 1, 16), (5, 3, 48),
                                   (7, 16, 16), (1, 9, 256)], ids=str)
def test_aligned_form_stores_every_byte_once(shape):
    np.testing.assert_array_equal(_aligned_form_writes(*shape), 1)
