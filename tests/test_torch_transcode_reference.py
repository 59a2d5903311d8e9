"""The benchmark's plain transcode reference (``torch_bench/reference/
transcode.py``) against native libjpeg (``hipe_tpu_torch.io_.jpeg``).

The reference is written from libjpeg's C and shares no code with the
port's codec. Its decode half has to give ``decode_bytes``'s pixels for a
q90 4:2:0 JPEG of a seeded photo-like image, and its encoder
``read_coefficients``'s coefficients of ``encode_bytes``, bit for bit, at
the benchmark's size, at a multiple of 16 and at sizes that are not.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hipe_tpu_torch.io_ import jpeg as tjpeg

BENCH = Path(__file__).resolve().parents[1] / "torch_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from gen import photo_like  # noqa: E402
from reference import transcode as ref  # noqa: E402

PARAMS = json.loads((BENCH / "configs" / "codec_5000x320x240_q90_420.json").read_text())["images"]
SIZES = [(240, 320), (32, 40), (33, 41), (17, 23)]


@pytest.fixture(scope="module", autouse=True)
def libjpeg():
    try:
        tjpeg._load()
    except RuntimeError as e:
        pytest.skip(f"libjpeg cannot be built: {e}")


def _images(h, w, seed, count=2):
    """``count`` seeded photo-like images, (count, h, w, 3) uint8."""
    planes = photo_like.planar(0, count, (count, h, w, 3), seed, PARAMS, "cpu")
    return planes.view(count, 3, h, w).permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decode_half_equals_libjpeg(h, w):
    for img in _images(h, w, 2 ** 31 + h * w):
        data = tjpeg.encode_bytes(img.numpy(), 90)
        co = tjpeg.read_coefficients(data)
        assert [(c.h_samp, c.v_samp) for c in co.components] == [(2, 2), (1, 1), (1, 1)]
        assert [c.coefs.shape[:2] for c in co.components] == ref.block_dims(h, w)
        coefs = [torch.from_numpy(c.coefs)[None] for c in co.components]
        got = ref.decode(coefs, h, w, 90)[0].numpy()
        np.testing.assert_array_equal(got, tjpeg.decode_bytes(data))


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_encode_equals_libjpeg(h, w):
    imgs = _images(h, w, 7 + h * w)
    mine = ref.encode(imgs, 90)
    for i, img in enumerate(imgs):
        co = tjpeg.read_coefficients(tjpeg.encode_bytes(img.numpy(), 90))
        for got, comp in zip(mine, co.components):
            np.testing.assert_array_equal(got[i].numpy(), comp.coefs)


def test_quant_tables_are_jpeg_set_quality():
    for q in (1, 25, 50, 75, 90, 100):
        assert ref.quant_tables(q) == tuple(list(t) for t in tjpeg.quality_tables(q))
