"""Kernel K1 against its plain version on the card (skips without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_blur.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import pytest
import torch

from hipe_tpu_torch.ops.blur import gaussian_blur_planar
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda, out_rows
from hipe_tpu_torch.runtime.device_stream import ROWS_PER_BLOCK_CANDIDATES

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(6, 240, 320), (5, 37, 53), (3, 1, 7), (2, 9, 1)])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_k1_matches_plain(cuda, radius, h_pad, shape):
    if not h_pad and shape[1] <= 2 * radius:
        pytest.skip("valid mode needs H > 2r")
    gen = torch.Generator(device=cuda).manual_seed(radius)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda, generator=gen)
    want = gaussian_blur_planar(x, radius, h_pad=h_pad)
    ho = out_rows(shape[1], radius, h_pad)
    before = gaussian_blur_planar_cuda.launches
    for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, ho}):
        got = gaussian_blur_planar_cuda(x, radius, h_pad=h_pad, rows_per_block=rpb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
    assert gaussian_blur_planar_cuda.launches > before


def test_k1_refuses_too_much_shared_memory(cuda):
    # One block per 256-row plane of width 512 needs 258*512*2 B > 227 KB.
    x = torch.zeros((1, 256, 512), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        gaussian_blur_planar_cuda(x, 1, rows_per_block=256)
    # The refused launch leaves no error behind for the next one.
    assert torch.equal(gaussian_blur_planar_cuda(x, 1), torch.zeros_like(x))
