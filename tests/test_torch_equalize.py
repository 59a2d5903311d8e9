"""The port's equalize and autocontrast against hipe_tpu and PIL, exactly.

The cases are ``tests/test_equalize.py``'s (uniform, lowrange, skewed,
constant, twovals, tiny and the LUT-overflow image) and its autocontrast
cases (the float64 quirk among them). Every op runs on CPU tensors; the JAX
functions run on the JAX CPU backend. Also: the host tables byte-equal to
hipe_tpu's, the closed-form trim against hipe_tpu's, the planar, rows and
channels-last layouts at odd widths and 1 and 3 channels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import equalize as jeq
from hipe_tpu_torch.ops import equalize as teq


def _cases():
    rng = np.random.default_rng(42)
    cases = {
        "uniform": rng.integers(0, 256, (64, 80, 3), np.uint8),
        "lowrange": rng.integers(90, 110, (64, 64, 3), np.uint8),
        "skewed": np.clip(rng.normal(40, 12, (128, 96, 3)), 0, 255).astype(np.uint8),
        "constant": np.full((48, 48, 3), 77, np.uint8),
        "twovals": np.where(rng.random((64, 64, 3)) < 0.7, 10, 200).astype(np.uint8),
        # step == 0: the non-last mass of a tiny image is under 255 pixels.
        "tiny": rng.integers(0, 256, (8, 8, 3), np.uint8),
    }
    # Most pixels in the last populated bin: raw LUT values exceed 255.
    a = np.full((256, 256, 3), 200, np.uint8)
    flat = a.reshape(-1, 3)
    idx = rng.choice(len(flat), 5536, replace=False)
    flat[idx] = rng.integers(0, 21, (5536, 3)).astype(np.uint8)
    cases["overflow"] = a
    return cases


def _ac_cases():
    rng = np.random.default_rng(23)
    cases = {
        "uniform": rng.integers(0, 256, (64, 80, 3), np.uint8),
        "narrow": rng.integers(100, 140, (64, 64, 3), np.uint8),
        "constant": np.full((32, 32, 3), 7, np.uint8),
        "fullrange": np.clip(rng.integers(-4, 260, (48, 48, 3)), 0, 255).astype(np.uint8),
    }
    # lo=26, hi=33: fl(255/7) < 255/7, so the max pixel maps to 254.
    q = rng.integers(26, 34, (40, 40, 3)).astype(np.uint8)
    q[0, 0] = 26
    q[0, 1] = 33
    cases["float_quirk"] = q
    return cases


CASES = _cases()
AC_CASES = _ac_cases()
CUTOFFS = [0, 1, 2, 10, (1, 5), (0, 20)]


def _pil(img, fn, **kw):
    from PIL import Image, ImageOps

    mode = "L" if img.ndim == 2 else "RGB"
    return np.asarray(getattr(ImageOps, fn)(Image.fromarray(img, mode), **kw))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- equalize ----


@pytest.mark.parametrize("name", list(CASES))
def test_equalize_matches_hipe_tpu_and_pil(name):
    img = CASES[name]
    want = _pil(img, "equalize")
    np.testing.assert_array_equal(teq.equalize_oracle(img), want)
    np.testing.assert_array_equal(teq.equalize_oracle(img), jeq.equalize_oracle(img))
    got = teq.equalize_nhwc(_t(img)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jeq.equalize_nhwc(jnp.asarray(img))))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("w", [1, 37])
def test_equalize_layouts_match_hipe_tpu(c, w):
    x = np.random.default_rng(w + c).integers(0, 256, (2, 19, w, c), np.uint8)
    x[1] //= 16  # a narrow range in the second image
    want = np.asarray(jeq.equalize_nhwc(jnp.asarray(x)))
    np.testing.assert_array_equal(teq.equalize_nhwc(_t(x)).numpy(), want)
    rows = teq.equalize_rows(_t(x.reshape(2, 19, w * c)), c).numpy()
    np.testing.assert_array_equal(rows.reshape(x.shape), want)
    planes = x.transpose(0, 3, 1, 2).reshape(2 * c, 19, w)
    got = teq.equalize_planar(_t(planes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jeq.equalize_planar(jnp.asarray(planes))))
    out = torch.empty(planes.shape, dtype=torch.uint8)
    assert teq.equalize_planar(_t(planes), out=out) is out
    np.testing.assert_array_equal(out.numpy(), got)


def test_equalize_grayscale_image_matches_pil():
    img = np.random.default_rng(7).integers(0, 256, (64, 64), np.uint8)
    got = teq.equalize_planar(_t(img[None]))[0].numpy()
    np.testing.assert_array_equal(got, _pil(img, "equalize"))


def test_histogram_and_lut_match_hipe_tpu():
    rng = np.random.default_rng(5)
    planes = rng.integers(0, 256, (6, 17, 23), np.uint8)
    planes[2] = 9
    planes[3] = np.where(planes[3] < 128, 3, 250)
    hist = teq.histogram_planes(_t(planes))
    assert hist.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(),
                                  np.asarray(jeq.histogram_planes(jnp.asarray(planes))))
    np.testing.assert_array_equal(
        teq.equalize_lut(hist, 17 * 23).numpy(),
        np.asarray(jeq.equalize_lut(jnp.asarray(hist.numpy()), 17 * 23)))
    lut = teq.equalize_lut(hist, 17 * 23)
    np.testing.assert_array_equal(
        teq.apply_lut(_t(planes), lut).numpy(),
        np.asarray(jeq.apply_lut(jnp.asarray(planes), jnp.asarray(lut.numpy()))))


# ---- autocontrast ----


def test_autocontrast_table_is_hipe_tpus():
    tab = teq._autocontrast_table()
    assert tab.dtype == np.uint8 and tab.shape == (256, 256, 256)
    assert tab.tobytes() == jeq._autocontrast_table().tobytes()


@pytest.mark.parametrize("cutoff", CUTOFFS, ids=["0", "1", "2", "10", "1-5", "0-20"])
@pytest.mark.parametrize("name", list(AC_CASES))
def test_autocontrast_matches_pil_and_hipe_tpu(name, cutoff):
    img = AC_CASES[name]
    want = _pil(img, "autocontrast", cutoff=cutoff)
    np.testing.assert_array_equal(teq.autocontrast_oracle(img, cutoff=cutoff), want)
    got = teq.autocontrast_nhwc(_t(img), cutoff=cutoff).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "float_quirk" and cutoff == 0:
        assert got[img == 33].max() == 254  # the float64 rounding, reproduced
    if name in ("uniform", "float_quirk"):
        np.testing.assert_array_equal(
            got, np.asarray(jeq.autocontrast_nhwc(jnp.asarray(img), cutoff=cutoff)))


@pytest.mark.parametrize("cutoff", [0, 2, (1, 3)])
def test_autocontrast_preserve_tone_matches_pil_and_hipe_tpu(cutoff):
    img = np.random.default_rng(61).integers(30, 220, (40, 48, 3)).astype(np.uint8)
    want = _pil(img, "autocontrast", cutoff=cutoff, preserve_tone=True)
    np.testing.assert_array_equal(teq.autocontrast_oracle(img, cutoff, preserve_tone=True),
                                  want)
    got = teq.autocontrast_nhwc(_t(img[None]), cutoff=cutoff, preserve_tone=True)[0].numpy()
    np.testing.assert_array_equal(got, want)
    # Planar grouping b*C + c: two images, each with its own range.
    two = np.stack([img, (img // 3 + 40).astype(np.uint8)])
    planes = two.transpose(0, 3, 1, 2).reshape(6, 40, 48)
    got = teq.autocontrast_planar(_t(planes), 3, cutoff=cutoff, preserve_tone=True).numpy()
    np.testing.assert_array_equal(got, np.asarray(jeq.autocontrast_planar(
        jnp.asarray(planes), 3, cutoff=cutoff, preserve_tone=True)))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("w", [1, 29])
def test_autocontrast_layouts_match_hipe_tpu(c, w):
    x = np.random.default_rng(w * c).integers(20, 200, (2, 15, w, c), np.uint8)
    kw = dict(cutoff=(2, 7), preserve_tone=c == 3)
    want = np.asarray(jeq.autocontrast_nhwc(jnp.asarray(x), **kw))
    np.testing.assert_array_equal(teq.autocontrast_nhwc(_t(x), **kw).numpy(), want)
    rows = teq.autocontrast_rows(_t(x.reshape(2, 15, w * c)), c, **kw).numpy()
    np.testing.assert_array_equal(rows.reshape(x.shape), want)


def test_autocontrast_extrema_match_hipe_tpu():
    rng = np.random.default_rng(11)
    hist = rng.integers(0, 40, (8, 256)).astype(np.int32)
    hist[:, :30] = 0
    hist[3] = 0
    hist[3, 100] = 500  # one populated bin
    hist[4, [5, 250]] = [7, 1]
    for cutoff in [(0, 0), (1, 1), (2, 7), (0, 20), (49, 50)]:
        lo, hi = teq.autocontrast_extrema(_t(hist), cutoff)
        jlo, jhi = jeq.autocontrast_extrema(jnp.asarray(hist), cutoff)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    got = teq.autocontrast_lut(lo, hi).numpy()
    np.testing.assert_array_equal(got, np.asarray(jeq.autocontrast_lut(np.asarray(jlo),
                                                                       np.asarray(jhi))))


@pytest.mark.parametrize("cutoff", [2.5, (60, 60), (1, 2, 3), -1, "2"])
def test_autocontrast_cutoff_validation(cutoff):
    with pytest.raises(ValueError, match="cutoff"):
        teq.autocontrast_oracle(np.zeros((8, 8, 3), np.uint8), cutoff=cutoff)
    with pytest.raises(ValueError, match="cutoff"):
        teq.autocontrast_nhwc(torch.zeros((8, 8, 3), dtype=torch.uint8), cutoff=cutoff)
    with pytest.raises(ValueError, match="cutoff"):
        jeq._normalize_cutoff(cutoff)
