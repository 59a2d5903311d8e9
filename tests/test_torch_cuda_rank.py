"""Kernel K3 against its plain version on the card (skips without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rank.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import pytest
import torch

from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
from hipe_tpu_torch.ops.planar import filter_planar
from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

pytestmark = pytest.mark.cuda

# Names no other test file registers: the registries are process-global.
RANK_NAME = "torchport_cuda_q"      # PIL RankFilter(5, 6)
KERNEL_NAME = "torchport_cuda_k"    # asymmetric 7x7, negative taps, offset -2.5
LUT_NAME = "torchport_cuda_rank_dim"
CHAINS = [
    ("median", "gaussian3"),
    ("erode", "dilate"),
    ("dilate", "erode"),
    ("median",),
    ("median5", "edge"),
    ("erode5", "dilate5"),
    ("median7",),
    ("posterize4", "median9"),
    ("pil_emboss", "gaussian3"),
    ("pil_find_edges", "pil_contour", "pil_smooth_more"),
    (RANK_NAME, "edge"),
    (LUT_NAME, KERNEL_NAME, "median", "gaussian9"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    tblur.register_rank_filter(RANK_NAME, 5, 6)
    tblur.register_kernel_filter(KERNEL_NAME, range(-24, 25), 7, -2.5)
    tblur.register_lut_filter(LUT_NAME, tblur.brightness_lut(0.7))
    return torch.device("cuda")


# Widths 1-5, 7, 53, 255, 257, 320 and 2100: runs that end inside and past
# the plane, rows that are not 16-byte aligned, more runs a row than threads.
SHAPES = [(6, 240, 320), (5, 37, 53), (3, 1, 7), (2, 9, 1), (1, 13, 2), (1, 11, 3),
          (1, 12, 4), (1, 10, 5), (2, 20, 255), (2, 21, 257), (2, 9, 2100)]


def _planes(cuda, shape, seed, offset=0):
    """Random planes; with ``offset`` 1 a contiguous view at storage offset
    1, so neither the planes nor their rows are aligned."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = shape[0] * shape[1] * shape[2]
    flat = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device=cuda,
                         generator=gen)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_k3_matches_plain(cuda, names, h_pad, shape, offset):
    r = tblur.chain_radius(names)
    if not h_pad and shape[1] <= 2 * r:
        pytest.skip("valid mode needs H > 2R")
    x = _planes(cuda, shape, len(names) * 100 + shape[1], offset)
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    # The output at storage offset 1 too: its rows take byte stores.
    out = torch.empty(want.numel() + offset, dtype=torch.uint8, device=cuda)[offset:]
    out = out.view(want.shape)
    ho = want.shape[1]
    before = rank_chain_planar_cuda.launches
    k2_before = filter_chain_planar_cuda.launches
    rpbs = sorted({*ROWS_PER_BLOCK_CANDIDATES, ho})
    for rpb in rpbs:
        got = filter_planar(x, names, h_pad=h_pad, rows_per_block=rpb, out=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
    assert rank_chain_planar_cuda.launches == before + len(rpbs)
    assert filter_chain_planar_cuda.launches == k2_before  # K2 never ran


def test_k3_refuses_a_program_it_does_not_take(cuda):
    x = torch.zeros((1, 16, 20000), dtype=torch.uint8, device=cuda)
    # More stages than K3 takes.
    with pytest.raises(RuntimeError, match="launch failed"):
        rank_chain_planar_cuda(x, ("median",) * 33)
    # A tile too wide for shared memory even at one row: 2*(1+2*12)*20000 B.
    with pytest.raises(RuntimeError, match="launch failed"):
        rank_chain_planar_cuda(x, ("median9", "median9", "median9"), rows_per_block=1)
    # The refused launches leave no error behind for the next one.
    got = rank_chain_planar_cuda(x[:, :, :256].contiguous(), ("median",) * 32)
    assert torch.equal(got, torch.zeros((1, 16, 256), dtype=torch.uint8, device=cuda))


@pytest.mark.parametrize("h_pad", [True, False])
def test_k3_halo_taller_than_the_tile(cuda, h_pad):
    """A median and 31 gaussian9 stages (total radius 125) at 8 rows a
    block through K3: the halo is 15 times the tile."""
    names = ("median",) + ("gaussian9",) * 31
    x = _planes(cuda, (2, 300, 40), 33)
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    for rpb in (8, 16, 32):
        got = rank_chain_planar_cuda(x, names, h_pad=h_pad, rows_per_block=rpb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
