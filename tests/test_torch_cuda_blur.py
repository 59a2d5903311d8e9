"""Kernel K1 against its plain version on the card (skips without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_blur.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import pytest
import torch

from hipe_tpu_torch.ops.blur import gaussian_blur_planar
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda, out_rows
from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# Widths 255, 257 and 768 are several warps of 32 runs a row; 53 and 7 are
# no multiple of a run. Where a row's runs are no multiple of 32 (320, 40, 8
# and 264 bytes among them) a warp spans planes; in the last four the stream
# leaves the last warp partly empty.
@pytest.mark.parametrize("shape", [(6, 240, 320), (5, 37, 53), (3, 1, 7), (2, 9, 1),
                                   (2, 20, 255), (2, 21, 257), (2, 19, 768),
                                   (33, 16, 40), (7, 5, 8), (5, 11, 264), (17, 240, 320)])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_matches_plain(cuda, offset, radius, h_pad, shape):
    """Every band height; at storage offset 1 the input and output rows are
    unaligned, so K1 takes its run form."""
    if not h_pad and shape[1] <= 2 * radius:
        pytest.skip("valid mode needs H > 2r")
    gen = torch.Generator(device=cuda).manual_seed(radius)
    numel = shape[0] * shape[1] * shape[2]
    x = torch.randint(0, 256, (numel + offset,), dtype=torch.uint8, device=cuda,
                      generator=gen)[offset:].view(shape)
    want = gaussian_blur_planar(x, radius, h_pad=h_pad)
    ho = out_rows(shape[1], radius, h_pad)
    out = torch.empty(want.numel() + offset, dtype=torch.uint8, device=cuda)[offset:]
    out = out.view(want.shape)
    before = gaussian_blur_planar_cuda.launches
    for rpb in sorted({1, *ROWS_PER_BLOCK_CANDIDATES, ho}):
        got = gaussian_blur_planar_cuda(x, radius, h_pad=h_pad, rows_per_block=rpb, out=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"rows_per_block={rpb}"
    assert gaussian_blur_planar_cuda.launches > before


def test_k1_refuses_too_much_shared_memory(cuda):
    """K1 takes no shared memory, so a whole-plane band of a 512-wide plane
    (258*512*2 B of row sums in the first design, over 227 KB) launches; what
    the kernel entry refuses (a radius outside 1-4, no rows a band) it
    refuses without a launch and leaves no error behind: its launcher raises
    with the caller's text and the code, and counts nothing."""
    x = torch.zeros((1, 256, 512), dtype=torch.uint8, device=cuda)
    assert torch.equal(gaussian_blur_planar_cuda(x, 1, rows_per_block=256), x)
    out = torch.empty_like(x)
    before = gaussian_blur_planar_cuda.launches
    for radius, rpb in ((5, 16), (1, 0)):
        with pytest.raises(RuntimeError, match=r"^K1 refused: .+ \(cudaError [1-9]\d*\)$"):
            gaussian_blur_planar_cuda.launch(x, lambda: "K1 refused", x.data_ptr(),
                                             out.data_ptr(), 1, 256, 512, radius, 1, rpb)
    assert gaussian_blur_planar_cuda.launches == before
    assert torch.equal(gaussian_blur_planar_cuda(x, 1), torch.zeros_like(x))
