"""Kernel K3 against its plain version on the card (skips without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rank.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import pytest
import torch

from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
from hipe_tpu_torch.runtime.device_stream import ROWS_PER_BLOCK_CANDIDATES

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


@pytest.mark.parametrize("shape", [(6, 240, 320), (5, 37, 53), (3, 1, 7), (2, 9, 1)])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_k3_matches_plain(cuda, names, h_pad, shape):
    r = tblur.chain_radius(names)
    if not h_pad and shape[1] <= 2 * r:
        pytest.skip("valid mode needs H > 2R")
    gen = torch.Generator(device=cuda).manual_seed(len(names) * 100 + shape[1])
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda, generator=gen)
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    ho = want.shape[1]
    before = rank_chain_planar_cuda.launches
    k2_before = filter_chain_planar_cuda.launches
    rpbs = sorted({*ROWS_PER_BLOCK_CANDIDATES, ho})
    for rpb in rpbs:
        got = filter_chain_planar_cuda(x, names, h_pad=h_pad, rows_per_block=rpb)
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
