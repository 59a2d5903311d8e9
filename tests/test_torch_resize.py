"""The port's bilinear resize on the CPU, held exactly against hipe_tpu and
an independent numpy oracle.

Mirrors ``test_resize.py``. The contract (half-pixel mapping, Q14 weights,
rounding after each pass; ``hipe_tpu_torch/ops/resize.py``) is written out
again below with per-pixel gathers; the port's gathered taps and
``hipe_tpu``'s fp32 banded matmuls must both give its integers (max-abs 0).
"""

import numpy as np
import pytest
import torch

from hipe_tpu.ops import resize as hrz
from hipe_tpu_torch.ops import resize as trz


def _axis_oracle(x: np.ndarray, n_out: int) -> np.ndarray:
    """One pass on the last axis of an int array, per the contract."""
    n_in = x.shape[-1]
    j = np.arange(n_out, dtype=np.float64)
    src = np.clip((j + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    wr = np.rint((src - lo) * (1 << 14)).astype(np.int64)
    wl = (1 << 14) - wr
    acc = x[..., lo].astype(np.int64) * wl + x[..., hi].astype(np.int64) * wr
    return (acc + (1 << 13)) >> 14


def _oracle(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    t = np.moveaxis(img, -1, -3)  # (..., C, H, W)
    if t.shape[-1] != ow:
        t = _axis_oracle(t, ow).astype(np.uint8)
    if t.shape[-2] != oh:
        t = np.swapaxes(_axis_oracle(np.swapaxes(t, -1, -2), oh), -1, -2)
    return np.moveaxis(t.astype(np.uint8), -3, -1)


def _rand(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


@pytest.mark.parametrize("ih,iw,oh,ow", [
    (48, 64, 24, 32),    # exact /2
    (48, 64, 17, 23),    # a non-integer ratio on both axes, down
    (24, 32, 48, 64),    # exact x2 up
    (33, 29, 40, 51),    # a non-integer ratio on both axes, up, odd dims
    (64, 48, 64, 20),    # W only
    (64, 48, 11, 48),    # H only
    (5, 7, 160, 3),      # extreme ratios both ways
    (256, 256, 144, 200),  # the card's phase-20 resize
])
@pytest.mark.parametrize("c", [1, 3])
def test_matches_hipe_tpu_and_oracle(ih, iw, oh, ow, c):
    img = np.stack([_rand(ih, iw, c, seed=s) for s in range(2)])
    got = trz.resize_bilinear(torch.from_numpy(img), oh, ow).numpy()
    np.testing.assert_array_equal(got, np.asarray(hrz.resize_bilinear(img, oh, ow)))
    np.testing.assert_array_equal(got, _oracle(img, oh, ow))


def test_identity_and_batch_and_gray():
    img = torch.from_numpy(_rand(20, 30))
    assert trz.resize_bilinear(img, 20, 30) is img
    batch = np.stack([_rand(20, 30, seed=s) for s in range(3)])
    got = trz.resize_bilinear(torch.from_numpy(batch), 9, 13).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], _oracle(batch[i], 9, 13))
    nested = torch.from_numpy(batch[:2]).reshape(1, 2, 20, 30, 3)
    np.testing.assert_array_equal(trz.resize_bilinear(nested, 9, 13)[0].numpy(), got[:2])
    gray = _rand(20, 30, c=1, seed=5)
    np.testing.assert_array_equal(trz.resize_bilinear(torch.from_numpy(gray), 31, 7).numpy(),
                                  _oracle(gray, 31, 7))
    with pytest.raises(ValueError, match="uint8"):
        trz.resize_bilinear(torch.zeros((4, 4, 3), dtype=torch.int32), 2, 2)


def test_planar_matches_interleaved_and_hipe_tpu():
    img = _rand(24, 40)
    planes = np.moveaxis(img, -1, 0).copy()  # (C, H, W)
    got = trz.resize_bilinear_planar(torch.from_numpy(planes), 15, 22).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(_oracle(img, 15, 22), -1, 0))
    np.testing.assert_array_equal(got, np.asarray(hrz.resize_bilinear_planar(planes, 15, 22)))
    with pytest.raises(ValueError, match="uint8"):
        trz.resize_bilinear_planar(torch.from_numpy(img[None]), 2, 2)


def test_flat_field_invariance():
    img = torch.full((13, 9, 3), 173, dtype=torch.uint8)
    assert (trz.resize_bilinear(img, 50, 4) == 173).all()


def test_chunks_give_the_same_integers(monkeypatch):
    """A pass in many batch chunks equals it in one."""
    batch = np.stack([_rand(17, 23, seed=s) for s in range(5)])
    whole = trz.resize_bilinear(torch.from_numpy(batch), 11, 29).numpy()
    monkeypatch.setattr(trz, "CHUNK_ELEMENTS", 100)
    np.testing.assert_array_equal(trz.resize_bilinear(torch.from_numpy(batch), 11, 29).numpy(),
                                  whole)
    np.testing.assert_array_equal(whole, _oracle(batch, 11, 29))
