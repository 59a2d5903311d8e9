"""The port's mode filter (PIL ``ModeFilter(3 | 5)``) against hipe_tpu and PIL.

Mirrors ``tests/test_mode_filter.py``: low-entropy images (modes
everywhere), binary images (ties), full-entropy images (the count > 2
gate), grayscale, the truncated window at the borders, the lowest-value tie
break; the planar, rows and channels-last layouts at odd widths and 1 and 3
channels; the sentinel kept in int16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import equalize as jeq
from hipe_tpu_torch.ops import equalize as teq


def _pil_mode(img, size):
    from PIL import Image, ImageFilter

    mode = "L" if img.ndim == 2 else "RGB"
    return np.asarray(Image.fromarray(img, mode).filter(ImageFilter.ModeFilter(size)))


def _quantized(rng, shape, levels):
    step = 255 // max(1, levels - 1)
    return (rng.integers(0, levels, shape) * step).astype(np.uint8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("size", [3, 5])
def test_mode_matches_pil_and_hipe_tpu(size):
    rng = np.random.default_rng(size)
    cases = [_quantized(rng, (36, 44, 3), 4), _quantized(rng, (17, 23, 3), 2),
             rng.integers(0, 256, (24, 30, 3), np.uint8)]
    for img in cases:
        want = _pil_mode(img, size)
        np.testing.assert_array_equal(teq.mode_oracle(img, size), want)
        got = teq.mode_nhwc(_t(img[None]), size=size)[0].numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(jeq.mode_nhwc(jnp.asarray(img[None]), size=size))[0])
    gray = _quantized(rng, (19, 27), 3)
    want = _pil_mode(gray, size)
    np.testing.assert_array_equal(teq.mode_oracle(gray, size), want)
    np.testing.assert_array_equal(teq.mode_planar(_t(gray[None]), size=size)[0].numpy(), want)


@pytest.mark.parametrize("name", ["mode", "mode5"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("hw", [(1, 7), (6, 1), (3, 3), (13, 29)])
def test_mode_layouts_match_hipe_tpu(name, c, hw):
    h, w = hw
    x = _quantized(np.random.default_rng(h + w + c), (2, h, w, c), 3)
    want = np.asarray(getattr(jeq, f"{name}_nhwc")(jnp.asarray(x)))
    np.testing.assert_array_equal(getattr(teq, f"{name}_nhwc")(_t(x)).numpy(), want)
    rows = getattr(teq, f"{name}_rows")(_t(x.reshape(2, h, w * c)), c).numpy()
    np.testing.assert_array_equal(rows.reshape(x.shape), want)
    planes = x.transpose(0, 3, 1, 2).reshape(2 * c, h, w)
    out = torch.empty(planes.shape, dtype=torch.uint8)
    assert getattr(teq, f"{name}_planar")(_t(planes), c, out=out) is out
    np.testing.assert_array_equal(out.numpy().reshape(2, c, h, w).transpose(0, 2, 3, 1), want)


def test_truncated_window_differs_from_clamp():
    # A corner pixel's window holds 4 (size 3) in-image pixels, not a
    # clamped 9: a value seen twice inside is no mode there.
    img = np.zeros((5, 5), np.uint8)
    img[0, 0], img[0, 1], img[1, 0] = 9, 9, 9
    got = teq.mode_planar(_t(img[None]))[0].numpy()
    np.testing.assert_array_equal(got, _pil_mode(img, 3))
    np.testing.assert_array_equal(got, np.asarray(jeq.mode_planar(jnp.asarray(img[None])))[0])


def test_tie_breaks_to_lowest_value():
    img = np.array([[50, 50, 50], [200, 200, 200], [7, 7, 7]], np.uint8)
    got = teq.mode_planar(_t(img[None]))[0].numpy()
    assert got[1, 1] == 7  # three each of 7, 50, 200
    np.testing.assert_array_equal(got, _pil_mode(img, 3))


def test_mode_core_keeps_the_sentinel_in_int16():
    xp = torch.full((1, 5, 5), teq._MODE_SENTINEL, dtype=torch.int16)
    xp[0, 1:4, 1:4] = 4
    got = teq._mode_core(xp, 3)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.full((1, 3, 3), 4))


def test_mode_rejects_bad_sizes_and_dtypes():
    with pytest.raises(ValueError, match="3 or 5"):
        teq.mode_planar(torch.zeros((1, 4, 4), dtype=torch.uint8), size=7)
    with pytest.raises(TypeError, match="uint8"):
        teq.mode_planar(torch.zeros((1, 4, 4), dtype=torch.int16))
