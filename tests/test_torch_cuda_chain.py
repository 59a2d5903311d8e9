"""Kernel K2 against its plain version on the card (skips without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_chain.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import pytest
import torch

from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

pytestmark = pytest.mark.cuda

# A name no other test file registers: the LUT registry is process-global.
LUT_NAME = "torchport_cuda_dim"
CHAINS = [
    ("gaussian3", "sharpen", "edge"),
    ("sharpen",),
    ("edge",),
    ("invert",),
    ("sharpen", "invert"),
    ("gaussian5", "solarize"),
    ("posterize4", "gaussian9", "edge"),
    ("gaussian7",),
    (LUT_NAME, "gaussian3", "posterize1"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
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
def test_k2_matches_plain(cuda, names, h_pad, shape, offset):
    r = tblur.chain_radius(names)
    if not h_pad and shape[1] <= 2 * r:
        pytest.skip("valid mode needs H > 2R")
    x = _planes(cuda, shape, len(names) * 100 + shape[1], offset)
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    # The output at storage offset 1 too: its rows take byte stores.
    out = torch.empty(want.numel() + offset, dtype=torch.uint8, device=cuda)[offset:]
    out = out.view(want.shape)
    ho = want.shape[1]
    before = filter_chain_planar_cuda.launches
    rpbs = sorted({*ROWS_PER_BLOCK_CANDIDATES, ho})
    for rpb in rpbs:
        got = filter_chain_planar_cuda(x, names, h_pad=h_pad, rows_per_block=rpb, out=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
    assert filter_chain_planar_cuda.launches == before + len(rpbs)


def test_k2_refuses_a_program_it_does_not_take(cuda):
    x = torch.zeros((1, 16, 20000), dtype=torch.uint8, device=cuda)
    # More stages than K2 takes.
    with pytest.raises(RuntimeError, match="launch failed"):
        filter_chain_planar_cuda(x, ("invert",) * 33)
    # A tile too wide for shared memory even at one row: 2*(1+2*3)*20000 B.
    with pytest.raises(RuntimeError, match="launch failed"):
        filter_chain_planar_cuda(x, ("gaussian3", "sharpen", "edge"), rows_per_block=1)
    # The refused launches leave no error behind for the next one.
    got = filter_chain_planar_cuda(x[:, :, :256].contiguous(), ("invert",) * 32)
    assert torch.equal(got, torch.zeros((1, 16, 256), dtype=torch.uint8, device=cuda))


@pytest.mark.parametrize("h_pad", [True, False])
def test_k2_halo_taller_than_the_tile(cuda, h_pad):
    """32 gaussian9 stages (total radius 128) at 8 rows a block: each
    stage's rows reach far past the tile, and past the plane's edges."""
    names = ("gaussian9",) * 32
    x = _planes(cuda, (2, 300, 40), 32)
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    for rpb in (8, 16, 32):
        got = filter_chain_planar_cuda(x, names, h_pad=h_pad, rows_per_block=rpb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"


# gaussian3, sharpen and edge first, in the middle and last, beside a point
# stage, a LUT and a wider gaussian: gaussian3 and edge walk down bands of
# rows in 16-bit lanes, the others go a run at a time.
WALK_CHAINS = [
    ("gaussian3", "invert", "sharpen", LUT_NAME, "edge"),
    ("edge", "sharpen", "gaussian3"),
    (LUT_NAME, "gaussian3", "edge", "posterize4"),
    ("solarize", "sharpen", "edge", "gaussian3", LUT_NAME),
    ("gaussian5", "edge", "invert", "gaussian3", "gaussian7"),
    ("edge", "edge", "gaussian3", "gaussian3"),
]


@pytest.mark.parametrize("shape", [(3, 240, 320), (2, 61, 257), (2, 45, 37)])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", WALK_CHAINS, ids="+".join)
def test_k2_walking_stages_in_every_position(cuda, names, h_pad, shape):
    """Every rows_per_block the autotune sweeps and the whole plane, on the
    benchmark's 240x320 planes and on odd widths."""
    x = _planes(cuda, shape, 7 * len(names) + shape[2])
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, want.shape[1]}):
        got = filter_chain_planar_cuda(x, names, h_pad=h_pad, rows_per_block=rpb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"


@pytest.mark.parametrize("shape", [(3, 240, 320), (2, 61, 257)])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", [("median", "gaussian3"), ("edge", "median", "sharpen")],
                         ids="+".join)
def test_k3_walking_stages(cuda, names, h_pad, shape):
    """K3 runs the same tile: its median, gaussian3 and edge walk too."""
    from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda

    x = _planes(cuda, shape, 11 * len(names) + shape[2])
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, want.shape[1]}):
        got = rank_chain_planar_cuda(x, names, h_pad=h_pad, rows_per_block=rpb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
