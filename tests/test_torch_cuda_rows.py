"""K1's and K2's rows entries, and Pipeline.apply_rows, against their plain
versions on the card (skips without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rows.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import pytest
import torch

from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_rows_cuda
from hipe_tpu_torch.ops.cuda_chain import filter_chain_rows_cuda
from hipe_tpu_torch.ops.cuda_tiled import filter_stage_planar_tiled_cuda
from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

pytestmark = pytest.mark.cuda

LUT_NAME = "torchport_cuda_rows_dim"
SHAPES = [(3, 37, 53), (2, 9, 1), (2, 1, 7), (2, 64, 96)]  # (B, H, W pixels)
# Rows of several warps of 32 runs.
WIDE_SHAPES = [(2, 20, 255), (2, 21, 257), (1, 19, 768)]
CHAINS = [("gaussian3", "sharpen", "edge"), ("edge",), ("gaussian5", "solarize"),
          ("posterize4", "gaussian9", "edge"), (LUT_NAME, "sharpen")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    tblur.register_lut_filter(LUT_NAME, tblur.brightness_lut(0.7))
    return torch.device("cuda")


def _rows(cuda, shape, c, seed):
    b, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randint(0, 256, (b, h, w * c), dtype=torch.uint8, device=cuda, generator=gen)


@pytest.mark.parametrize("shape", SHAPES + WIDE_SHAPES)
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_rows_matches_plain(cuda, offset, radius, h_pad, c, shape):
    """C = 1-4 with r*C <= 8 on aligned rows is K1's pairs form; r*C beyond
    one run, C = 5, 8 or 9, and storage offset 1 (unaligned rows) its run
    form."""
    if not h_pad and shape[1] <= 2 * radius:
        pytest.skip("valid mode needs H > 2r")
    b, h, w = shape
    full = _rows(cuda, (b * h * w + 1, 1, 1), c, seed=radius * 10 + c).flatten()
    x = full[offset:offset + b * h * w * c].view(b, h, w * c)
    want = tblur.gaussian_blur_rows(x, c, radius, h_pad=h_pad)
    out = torch.empty(want.numel() + offset, dtype=torch.uint8, device=cuda)[offset:]
    out = out.view(want.shape)
    before = gaussian_blur_rows_cuda.launches
    for rpb in (1, 8, 64, want.shape[1]):
        got = gaussian_blur_rows_cuda(x, c, radius, h_pad=h_pad, rows_per_block=rpb, out=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
    assert gaussian_blur_rows_cuda.launches == before + 4


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_rows_warps_span_images(cuda, offset, radius, h_pad):
    """The engine's and the codec's rows, C = 3 at 320 pixels (960 bytes,
    120 runs: no multiple of 32), an odd image count: warps span images and
    the last is partly empty; every rows_per_block candidate."""
    b, h, w, c = 3, 240, 320, 3
    full = _rows(cuda, (b * h * w + 1, 1, 1), c, seed=radius).flatten()
    x = full[offset:offset + b * h * w * c].view(b, h, w * c)
    want = tblur.gaussian_blur_rows(x, c, radius, h_pad=h_pad)
    out = torch.empty(want.numel() + offset, dtype=torch.uint8, device=cuda)[offset:]
    out = out.view(want.shape)
    rpbs = sorted({1, *ROWS_PER_BLOCK_CANDIDATES, want.shape[1]})
    before = gaussian_blur_rows_cuda.launches
    for rpb in rpbs:
        got = gaussian_blur_rows_cuda(x, c, radius, h_pad=h_pad, rows_per_block=rpb, out=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
    assert gaussian_blur_rows_cuda.launches == before + len(rpbs)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_k2_rows_matches_plain(cuda, names, h_pad, c, shape):
    if not h_pad and shape[1] <= 2 * tblur.chain_radius(names):
        pytest.skip("valid mode needs H > 2R")
    x = _rows(cuda, shape, c, seed=len(names) * 10 + c)
    want = tblur.filter_chain_rows(x, c, names, h_pad=h_pad)
    before = filter_chain_rows_cuda.launches
    for rpb in (1, 32, want.shape[1]):
        got = filter_chain_rows_cuda(x, c, names, h_pad=h_pad, rows_per_block=rpb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
    assert filter_chain_rows_cuda.launches == before + 3


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("name", ["blur3", "blur9", "chain", "denoise", "median9"])
def test_apply_rows_and_nhwc_match_plain(cuda, name, h_pad, c):
    pipe = tplib.get(name)
    x = _rows(cuda, (3, 40, 45), c, seed=c)
    want = tblur.filter_chain_rows(x, c, pipe.filters, h_pad=h_pad)
    assert torch.equal(pipe.apply_rows(x, c, h_pad=h_pad), want)
    out = torch.empty_like(want)
    assert pipe.apply_rows(x, c, h_pad=h_pad, out=out) is out
    assert torch.equal(out, want)
    nhwc = x.view(3, 40, 45, c)
    assert torch.equal(pipe.apply_nhwc(nhwc, h_pad=h_pad), want.view(3, -1, 45, c))


def test_wide_rows_relayout_to_the_tiled_route(cuda):
    # 40 x 3500 RGB rows: 3500-wide planes of the chain route tiled
    # (Pipeline.routes_tiled), so it relayouts to planar and runs K4 and K5;
    # K1's rows entry takes no shared memory, so blur3 stays on it.
    from hipe_tpu_torch.ops.cuda_tiled import gaussian_blur_planar_tiled_cuda

    x = _rows(cuda, (1, 40, 3500), 3, seed=7)
    for name, k1, k4, k5 in (("blur3", 1, 0, 0), ("chain", 0, 1, 2)):
        pipe = tplib.get(name)
        assert pipe.single_gaussian == bool(k1)
        assert pipe.routes_tiled(40, 3500) == (not k1)
        want = tblur.filter_chain_rows(x, 3, pipe.filters)
        before = (gaussian_blur_rows_cuda.launches, gaussian_blur_planar_tiled_cuda.launches,
                  filter_stage_planar_tiled_cuda.launches)
        assert torch.equal(pipe.apply_rows(x, 3), want)
        assert (gaussian_blur_rows_cuda.launches, gaussian_blur_planar_tiled_cuda.launches,
                filter_stage_planar_tiled_cuda.launches) == (
                    before[0] + k1, before[1] + k4, before[2] + k5)


def test_rows_entries_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 16, 200000), dtype=torch.uint8, device=cuda)
    # K2's rows tile is too wide for shared memory even at one row; K1's
    # rows entry takes no shared memory and blurs it.
    assert torch.equal(gaussian_blur_rows_cuda(x, 4, 1, rows_per_block=1), x)
    with pytest.raises(RuntimeError, match="launch failed"):
        filter_chain_rows_cuda(x, 4, ("gaussian3", "sharpen"), rows_per_block=1)
    with pytest.raises(ValueError, match="band and point"):
        filter_chain_rows_cuda(x, 4, ("median",))
    # The refused launches leave no error behind for the next one.
    small = x[:, :, :300].contiguous()
    assert torch.equal(gaussian_blur_rows_cuda(small, 3, 2), small)
