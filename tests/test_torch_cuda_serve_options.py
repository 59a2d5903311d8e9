"""The serving options, scaled/gray/CMYK decode, resize and the lossless
transforms on the card, held against the same functions on CPU tensors
(skip without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serve_options.py -q

The machine with the card has no libjpeg, so the inputs are coefficient sets
the port's encoder makes from seeded pixels (K7 on the card, its plain
version on the CPU), never bytes.
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.io_.jpeg import quality_tables
from hipe_tpu_torch.ops import cuda_dct
from hipe_tpu_torch.ops import jpeg_decode as jd
from hipe_tpu_torch.ops import jpeg_encode as je
from hipe_tpu_torch.ops import jpeg_transform as jt
from hipe_tpu_torch.ops import resize as rz
from hipe_tpu_torch.ops.equalize import colorize_lut
from hipe_tpu_torch.runtime.serve import ServingPipeline

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
LUT = colorize_lut("#000080", "#ffe0a0", "#800000")
OPTIONS = {
    "decode_scale=2": {"decode_scale": 2},
    "decode_scale=4": {"decode_scale": 4},
    "decode_scale=8": {"decode_scale": 8},
    "decode_gray": {"decode_gray": True},
    "gray_output": {"gray_output": True},
    "output_scale=2": {"output_scale": 2},
    "resize_to": {"resize_to": (29, 70)},
    "decode_gray+colorize": {"decode_gray": True, "colorize": LUT},
    "gray_output+colorize": {"gray_output": True, "colorize": LUT},
    "decode_scale=2+output_scale=2+gray_output": {"decode_scale": 2, "output_scale": 2,
                                                   "gray_output": True},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _coefficients(sub: str, h: int = 41, w: int = 55, n: int = 3):
    """(geometry, qkey, per-component CPU coefficients) of n seeded images."""
    img = torch.from_numpy(np.random.default_rng(h * w).integers(0, 256, (n, h, w, 3),
                                                                 dtype=np.uint8))
    geo = je.encode_geometry(h, w, 3, sub)
    luma, chroma = quality_tables(85)
    qts = [luma, chroma, chroma]
    return geo, tuple(tuple(int(v) for v in q) for q in qts), je.encode_planes(geo, img, qts)


def _same(got, want):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("sub", ["420", "422", "444"])
@pytest.mark.parametrize("name", OPTIONS)
def test_options_on_the_card_equal_the_cpu(cuda, name, sub):
    geo, qkey, coefs = _coefficients(sub)
    sps = [ServingPipeline("blur3", device=d, decode_on_device=True, encode_on_device=True,
                           **OPTIONS[name]) for d in (cuda, CPU)]
    g, q = sps[0]._maybe_gray_geo(geo, qkey)
    ins = coefs[:g.ncomps]
    for fns in ((sps[0].decode_filter_fn, sps[1].decode_filter_fn),
                (sps[0].transcode_fn, sps[1].transcode_fn)):
        got = fns[0](g, q)(*[c.to(cuda) for c in ins])
        _same(got, fns[1](g, q)(*ins))
    for sp in sps:
        sp.close()


def test_the_card_filters_host_pixels_with_every_option(cuda):
    """The pixel-input placements (the host decode's filter and encode) too."""
    batch = np.random.default_rng(3).integers(0, 256, (2, 33, 47, 3), dtype=np.uint8)
    for opts in OPTIONS.values():
        if "colorize" in opts and "gray_output" not in opts:
            continue  # colorize needs a grayscale stage output
        sps = [ServingPipeline("blur3", device=d, **opts) for d in (cuda, CPU)]
        np.testing.assert_array_equal(sps[0]._filter_device(batch), sps[1]._filter_device(batch))
        a = sps[0].encode_fn(33, 47, 3, with_filter=True)(
            torch.from_numpy(batch.reshape(2, 33, 141)).to(cuda))
        _same(a, sps[1].encode_fn(33, 47, 3, with_filter=True)(
            torch.from_numpy(batch.reshape(2, 33, 141))))
        for sp in sps:
            sp.close()


@pytest.mark.parametrize("denom,k6", [(1, 3), (2, 2), (4, 0), (8, 0)])
def test_scaled_size_8_components_launch_k6(cuda, denom, k6):
    """At 1/2 the 4:2:0 chroma keeps scaled size 8: K6, never the plain IDCT."""
    geo, qkey, coefs = _coefficients("420")
    assert sum(s == 8 for s in jd.scaled_sizes(geo, denom)) == k6
    before = cuda_dct.dequant_idct_cuda.launches
    got = jd.decode_planes_scaled(geo, [c.to(cuda) for c in coefs], list(qkey), denom)
    torch.cuda.synchronize()
    assert cuda_dct.dequant_idct_cuda.launches == before + k6
    _same(got, jd.decode_planes_scaled(geo, coefs, list(qkey), denom))


def _four_components(color: int, h: int = 39, w: int = 59, n: int = 2):
    """(geometry, coefficients) of n random CMYK (4) or YCCK (5) block grids
    with libjpeg's samplings for them."""
    samp = ((1, 1),) * 4 if color == 4 else ((2, 2), (1, 1), (1, 1), (2, 2))
    max_h, max_v = max(a for a, _ in samp), max(b for _, b in samp)
    rng = np.random.default_rng(color)
    comps, coefs = [], []
    for hs, vs in samp:
        dh, dw = -(-h * vs // max_v), -(-w * hs // max_h)
        hb, wb = -(-dh // 8), -(-dw // 8)
        coefs.append(torch.from_numpy(rng.integers(-300, 300, (n, hb, wb, 64)).astype(np.int16)))
        comps.append((hs, vs, wb, hb))
    return jd.DecodeGeometry(w, h, 4, tuple(comps), max_h, max_v, color), coefs


@pytest.mark.parametrize("color", [4, 5])
@pytest.mark.parametrize("denom", [1, 2, 8])
def test_cmyk_decode_launches_k6(cuda, color, denom):
    geo, coefs = _four_components(color)
    assert jd.supported_scaled(geo, denom)
    qts = [np.random.default_rng(i).integers(1, 100, 64) for i in range(4)]
    k6 = sum(s == 8 for s in jd.scaled_sizes(geo, denom))
    assert denom > 1 or k6 == 4
    before = cuda_dct.dequant_idct_cuda.launches
    got = jd.decode_planes_scaled(geo, [c.to(cuda) for c in coefs], qts, denom)
    torch.cuda.synchronize()
    assert cuda_dct.dequant_idct_cuda.launches == before + k6
    _same(got, jd.decode_planes_scaled(geo, coefs, qts, denom))


@pytest.mark.parametrize("ssize", [1, 2, 4])
def test_reduced_idcts_on_the_card_equal_the_cpu(cuda, ssize):
    coefs = torch.from_numpy(np.random.default_rng(ssize).integers(
        -32768, 32768, (3, 9, 11, 64)).astype(np.int16))
    q = np.random.default_rng(ssize + 1).integers(1, 65536, 64)
    got = jd._scaled_grid(coefs.to(cuda), q, ssize)
    _same(got, jd._scaled_grid(coefs, q, ssize))


@pytest.mark.parametrize("op", jt.OPS)
def test_transforms_on_the_card_equal_the_cpu(cuda, op):
    coefs = torch.from_numpy(np.random.default_rng(len(op)).integers(
        -32768, 32768, (4, 5, 7, 64)).astype(np.int16))
    _same(jt.transform_component(coefs.to(cuda), op), jt.transform_component(coefs, op))


@pytest.mark.parametrize("shape,out", [((3, 48, 64, 3), (17, 23)), ((2, 33, 29, 1), (40, 51)),
                                       ((5, 256, 256, 3), (144, 200))])
def test_resize_on_the_card_equals_the_cpu(cuda, shape, out):
    img = torch.from_numpy(np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                                      dtype=np.uint8))
    _same(rz.resize_bilinear(img.to(cuda), *out), rz.resize_bilinear(img, *out))
    planes = img[..., 0]
    _same(rz.resize_bilinear_planar(planes.to(cuda), *out),
          rz.resize_bilinear_planar(planes, *out))
