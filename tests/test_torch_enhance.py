"""The port's contrast, color and sharpness against hipe_tpu and PIL, exactly.

Mirrors ``tests/test_contrast.py``, ``tests/test_color.py`` and
``tests/test_sharpness.py``: each factor (0 and 1 among them) against PIL's
``ImageEnhance`` and hipe_tpu's op on the JAX CPU backend, in the planar,
rows and channels-last layouts, 1- and 3-channel images, odd widths; the
host tables byte-equal to hipe_tpu's; the luma and its rounded mean; the
copied ``kernel_oracle``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import equalize as jeq
from hipe_tpu.ops import reference as jref
from hipe_tpu_torch.ops import equalize as teq
from hipe_tpu_torch.ops import reference as tref

CONTRAST_FACTORS = [0.0, 0.5, 0.8, 1.0, 1.3, 1.9, 2.5]
COLOR_FACTORS = [0.0, 0.3, 0.75, 1.0, 1.5, 2.2]
SHARPNESS_FACTORS = [0.0, 0.4, 1.0, 1.7, 2.0]


def _pil(img, kind, factor):
    from PIL import Image, ImageEnhance

    mode = "L" if img.ndim == 2 else "RGB"
    return np.asarray(getattr(ImageEnhance, kind)(Image.fromarray(img, mode)).enhance(factor))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _layouts(op, x, **kw):
    """The port's op on (B, H, W, C) ``x`` in nhwc, rows and planar form."""
    b, h, w, c = x.shape
    nhwc = getattr(teq, f"{op}_nhwc")(_t(x), **kw).numpy()
    rows = getattr(teq, f"{op}_rows")(_t(x.reshape(b, h, w * c)), c, **kw).numpy()
    planes = x.transpose(0, 3, 1, 2).reshape(b * c, h, w)
    planar = getattr(teq, f"{op}_planar")(_t(planes), c, **kw).numpy()
    return nhwc, rows.reshape(x.shape), planar.reshape(b, c, h, w).transpose(0, 2, 3, 1)


# ---- contrast ----


@pytest.mark.parametrize("factor", CONTRAST_FACTORS)
def test_contrast_matches_pil_and_hipe_tpu(factor):
    rng = np.random.default_rng(int(factor * 100) + 1)
    img = rng.integers(0, 256, (40, 52, 3), np.uint8)
    want = _pil(img, "Contrast", factor)
    np.testing.assert_array_equal(teq.contrast_oracle(img, factor), want)
    np.testing.assert_array_equal(teq.contrast_nhwc(_t(img), factor=factor).numpy(), want)
    gray = rng.integers(0, 256, (24, 30), np.uint8)
    want_g = _pil(gray, "Contrast", factor)
    np.testing.assert_array_equal(teq.contrast_oracle(gray, factor), want_g)
    got_g = teq.contrast_planar(_t(gray[None]), 1, factor=factor)[0].numpy()
    np.testing.assert_array_equal(got_g, want_g)
    assert teq._contrast_table(factor).tobytes() == jeq._contrast_table(factor).tobytes()


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("w", [1, 41])
def test_contrast_layouts_match_hipe_tpu(c, w):
    x = np.random.default_rng(w + 7 * c).integers(0, 256, (3, 16, w, c), np.uint8)
    x[1] //= 4
    want = np.asarray(jeq.contrast_nhwc(jnp.asarray(x), factor=0.6))
    for got in _layouts("contrast", x, factor=0.6):
        np.testing.assert_array_equal(got, want)


def test_luma_and_rounded_mean_match_hipe_tpu():
    rng = np.random.default_rng(3)
    img4 = rng.integers(0, 256, (4, 3, 13, 17), np.uint8)
    img4[2] = 255
    luma = teq.pil_luma(_t(img4))
    np.testing.assert_array_equal(luma.numpy(), np.asarray(jeq.pil_luma(jnp.asarray(img4))))
    hist = teq.histogram_planes(luma)
    np.testing.assert_array_equal(
        teq.luma_mean_round_half(hist, 13 * 17).numpy(),
        np.asarray(jeq.luma_mean_round_half(jnp.asarray(hist.numpy()), 13 * 17)))
    with pytest.raises(ValueError, match="1- or 3-channel"):
        teq.pil_luma(torch.zeros((1, 4, 2, 2), dtype=torch.uint8))
    with pytest.raises(ValueError, match="too large"):
        teq.luma_mean_round_half(hist, 12_700_000)


def test_rounded_mean_at_the_pixel_bound():
    """Near-white images at the largest sizes both packages take: the port
    gives the exact int((2S + N) / (2N)) up to the bound. hipe_tpu's int32
    form equals it while 171 * npix < 2^31; between that and its 170 *
    npix guard its third numerator (2 * S_3 + npix) wraps (ROADMAP.md)."""
    for npix in ((2 ** 31 - 1) // 171, (2 ** 31 - 1) // 170):
        hist = np.zeros((2, 256), np.int32)
        hist[0, 255], hist[0, 0] = npix - 1, 1
        hist[1, 128] = npix
        s = np.array([255 * (npix - 1), 128 * npix], np.int64)
        exact = (2 * s + npix) // (2 * npix)
        got = teq.luma_mean_round_half(_t(hist), npix).numpy()
        np.testing.assert_array_equal(got, exact)
        if 171 * npix < 2 ** 31:
            np.testing.assert_array_equal(
                got, np.asarray(jeq.luma_mean_round_half(jnp.asarray(hist), npix)))


# ---- color ----


@pytest.mark.parametrize("factor", COLOR_FACTORS)
def test_color_matches_pil_and_hipe_tpu(factor):
    rng = np.random.default_rng(int(factor * 100) + 3)
    img = rng.integers(0, 256, (36, 44, 3), np.uint8)
    want = _pil(img, "Color", factor)
    np.testing.assert_array_equal(teq.color_oracle(img, factor), want)
    got = teq.color_nhwc(_t(img[None]), factor=factor)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jeq.color_nhwc(jnp.asarray(img[None]), factor=factor))[0])
    assert (teq._color_product_table(factor).tobytes()
            == jeq._color_product_table(factor).tobytes())


@pytest.mark.parametrize("w", [1, 39])
def test_color_layouts_and_grayscale_identity(w):
    x = np.random.default_rng(w).integers(0, 256, (2, 14, w, 3), np.uint8)
    want = np.asarray(jeq.color_nhwc(jnp.asarray(x), factor=1.8))
    for got in _layouts("color", x, factor=1.8):
        np.testing.assert_array_equal(got, want)
    gray = x[..., :1]
    for got in _layouts("color", gray, factor=1.8):
        np.testing.assert_array_equal(got, gray)
    out = torch.empty((2, 14, w), dtype=torch.uint8)
    assert teq.color_planar(_t(gray[..., 0]), 1, factor=3.0, out=out) is out
    np.testing.assert_array_equal(out.numpy(), gray[..., 0])


# ---- sharpness ----


def test_kernel_oracle_is_hipe_tpus():
    img = np.random.default_rng(2).integers(0, 256, (11, 13, 3), np.uint8)
    for taps, scale, offset in [((1, 1, 1, 1, 5, 1, 1, 1, 1), 13, 0),
                                ((-1, 0, 0, 0, 1, 0, 0, 0, 0), 1, 128),
                                (tuple(range(25)), 300, 0.5)]:
        np.testing.assert_array_equal(tref.kernel_oracle(img, taps, scale, offset),
                                      jref.kernel_oracle(img, taps, scale, offset))


@pytest.mark.parametrize("factor", SHARPNESS_FACTORS)
def test_sharpness_matches_pil_and_hipe_tpu(factor):
    rng = np.random.default_rng(int(factor * 100) + 5)
    img = rng.integers(0, 256, (36, 44, 3), np.uint8)
    want = _pil(img, "Sharpness", factor)
    np.testing.assert_array_equal(teq.sharpness_oracle(img, factor), want)
    got = teq.sharpness_nhwc(_t(img[None]), factor=factor)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jeq.sharpness_nhwc(jnp.asarray(img[None]), factor=factor))[0])
    gray = rng.integers(0, 256, (24, 30), np.uint8)
    want_g = _pil(gray, "Sharpness", factor)
    np.testing.assert_array_equal(teq.sharpness_oracle(gray, factor), want_g)
    np.testing.assert_array_equal(
        teq.sharpness_planar(_t(gray[None]), 1, factor=factor)[0].numpy(), want_g)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("hw", [(1, 9), (7, 1), (2, 2), (17, 31)])
def test_sharpness_layouts_and_borders_match_hipe_tpu(c, hw):
    h, w = hw
    x = np.random.default_rng(h * w + c).integers(0, 256, (2, h, w, c), np.uint8)
    want = np.asarray(jeq.sharpness_nhwc(jnp.asarray(x), factor=2.0))
    for got in _layouts("sharpness", x, factor=2.0):
        np.testing.assert_array_equal(got, want)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_array_equal(want[edge], x[edge])
