"""The benchmark's plain ``mode5`` reference (``torch_bench/reference/
mode5.py``) against PIL's ``ImageFilter.ModeFilter(5)`` and the port's
``mode5_planar``.

The reference is written from Pillow's ``ModeFilter.c`` and shares no code
with the port's pairwise form. It has to give PIL's bytes on the benchmark
configuration's photo-like images at its 240x320 and at sizes that are not;
on quantized images (modes everywhere), binary images (ties) and
full-entropy images (the count > 2 gate); at a corner whose truncated
window picks another value than a clamped one would; and in sub-blocks of
one plane as in one block. In bfloat16 (the control) its key loses the
value, and it does not.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hipe_tpu_torch.ops import equalize as teq

BENCH = Path(__file__).resolve().parents[1] / "torch_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from gen import photo_like  # noqa: E402
from reference import mode5 as ref  # noqa: E402

PARAMS = json.loads((BENCH / "configs" / "modefilter5_5000x320x240_rgb.json").read_text())["images"]
SIZES = [(240, 320), (33, 41), (17, 23)]


def _pil(planes: np.ndarray) -> np.ndarray:
    """PIL ``ModeFilter(5)`` on each (H, W) uint8 plane of ``planes``."""
    from PIL import Image, ImageFilter

    return np.stack([np.asarray(Image.fromarray(p, "L").filter(ImageFilter.ModeFilter(5)))
                     for p in planes])


def _photo(h, w, seed, count=2) -> torch.Tensor:
    """``count`` seeded photo-like RGB images as (count*3, h, w) uint8 planes."""
    return photo_like.planar(0, count, (count, h, w, 3), seed, PARAMS, "cpu")


def _synthetic(kind, h, w, seed) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "quantized":
        x = rng.integers(0, 4, (3, h, w)) * 85
    elif kind == "binary":
        x = rng.integers(0, 2, (3, h, w)) * 255
    else:
        x = rng.integers(0, 256, (3, h, w))
    return torch.from_numpy(x.astype(np.uint8))


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_photo_like_images_equal_pil_and_the_port(h, w):
    planes = _photo(h, w, 2 ** 31 + h * w)
    want = ref.apply(planes)
    # PIL on the RGB images filters each band alone.
    from PIL import Image, ImageFilter

    rgb = planes.view(2, 3, h, w).permute(0, 2, 3, 1).numpy()
    pil = np.stack([np.asarray(Image.fromarray(img, "RGB").filter(ImageFilter.ModeFilter(5)))
                    for img in rgb])
    np.testing.assert_array_equal(want.view(2, 3, h, w).permute(0, 2, 3, 1).numpy(), pil)
    assert torch.equal(teq.mode5_planar(planes), want)
    # Both branches: pixels replaced by a mode, and pixels kept.
    changed = (want != planes).float().mean()
    assert 0 < changed < 1


@pytest.mark.parametrize("kind", ["quantized", "binary", "full_entropy"])
@pytest.mark.parametrize("h,w", SIZES[1:], ids=[f"{h}x{w}" for h, w in SIZES[1:]])
def test_synthetic_images_equal_pil_and_the_port(kind, h, w):
    planes = _synthetic(kind, h, w, h * w + len(kind))
    want = ref.apply(planes)
    np.testing.assert_array_equal(want.numpy(), _pil(planes.numpy()))
    assert torch.equal(teq.mode5_planar(planes), want)


def test_truncated_corner_window_is_not_a_clamped_one():
    """At (0, 0) the truncated 3x3 part of the window holds 200 three times
    and the corner's 7 once: PIL takes 200. Clamped (edge-replicated), the
    corner would fill 9 of the 25 places and 7 would win."""
    img = (np.arange(81, dtype=np.uint8) + 10).reshape(9, 9)
    img[0, 0] = 7
    img[1, 1] = img[2, 2] = img[2, 1] = 200
    vals, counts = np.unique(np.pad(img, 2, mode="edge")[0:5, 0:5], return_counts=True)
    assert vals[counts.argmax()] == 7
    planes = torch.from_numpy(img[None].copy())
    want = ref.apply(planes)
    assert int(want[0, 0, 0]) == 200 == int(_pil(img[None])[0, 0, 0])
    np.testing.assert_array_equal(want.numpy(), _pil(img[None]))
    assert torch.equal(teq.mode5_planar(planes), want)


def test_sub_blocks_give_one_blocks_bytes(monkeypatch):
    planes = _photo(33, 41, 77)
    whole = ref.apply(planes)
    monkeypatch.setattr(ref, "BLOCK_COUNTS", 1)
    assert torch.equal(ref.apply(planes), whole)


@pytest.mark.parametrize("h,w", SIZES[1:], ids=[f"{h}x{w}" for h, w in SIZES[1:]])
def test_bfloat16_key_gives_another_result(h, w):
    planes = _photo(h, w, 2 ** 31 + 3 * h)
    diff = (ref.apply(planes, torch.bfloat16).int() - ref.apply(planes).int()).abs()
    assert int(diff.max()) > 0
