"""Kernels K6 and K7 and the device codec on the card (skip without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dct.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import math

import numpy as np
import pytest
import torch

from hipe_tpu_torch.io_.jpeg import quality_tables
from hipe_tpu_torch.ops import cuda_dct
from hipe_tpu_torch.ops import jpeg_decode as jd
from hipe_tpu_torch.ops import jpeg_encode as je
from hipe_tpu_torch.runtime.serve import ServingPipeline

pytestmark = pytest.mark.cuda

GRIDS = [(1, 1), (5, 7), (4, 16), (32, 32), (16, 16), (282, 500)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _table(gen, wide: bool) -> torch.Tensor:
    q = torch.randint(1, 65536 if wide else 256, (64,), generator=gen)
    if wide:
        q[5] = 65535
    return q


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("full,wide", [(True, True), (True, False), (False, False)])
def test_k6_matches_plain(cuda, grid, full, wide):
    gen = torch.Generator().manual_seed(grid[0] * 1000 + grid[1])
    b = 1 + (grid[0] + grid[1]) % 8
    lo, hi = (-32768, 32768) if full else (-2048, 2048)
    coefs = torch.randint(lo, hi, (b, *grid, 64), generator=gen, dtype=torch.int32)
    coefs = coefs.to(torch.int16)
    if full:
        coefs.view(-1)[:3] = torch.tensor([32767, -32767, -32768], dtype=torch.int16)
    q = _table(gen, wide)
    coefs = coefs.to(cuda)
    before = cuda_dct.dequant_idct_cuda.launches
    got = cuda_dct.dequant_idct_cuda(coefs, q)
    torch.cuda.synchronize()
    assert cuda_dct.dequant_idct_cuda.launches == before + 1
    assert torch.equal(got, jd.idct8x8_islow(coefs, q))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("table", ["q1", "q50", "q75", "q90", "q100", "8-bit", "16-bit"])
def test_k7_matches_plain(cuda, grid, table):
    gen = torch.Generator().manual_seed(grid[0] * 1000 + grid[1] + len(table))
    b = 1 + (grid[0] * grid[1]) % 8
    x = torch.randint(0, 256, (b, grid[0] * 8, grid[1] * 8), generator=gen, dtype=torch.uint8)
    q = (quality_tables(int(table[1:]))[len(table) % 2] if table.startswith("q")
         else _table(gen, table == "16-bit"))
    x = x.to(cuda)
    before = cuda_dct.fdct_quantize_cuda.launches
    got = cuda_dct.fdct_quantize_cuda(x, q)
    torch.cuda.synchronize()
    assert cuda_dct.fdct_quantize_cuda.launches == before + 1
    assert torch.equal(got, je.fdct_quantize_plain(x, q))


def _extreme_blocks() -> torch.Tensor:
    """(130, 8, 8) uint8: for each coefficient the block of 0s and 255s by the
    signs of its DCT basis (its largest value), the complement (its least),
    and blocks of 0s and of 255s (the DC's, |t| 8192 and 8128)."""
    x = torch.arange(8, dtype=torch.float64)
    pos = torch.stack([torch.cos((2 * x + 1) * u * math.pi / 16) for u in range(8)]) > 0
    top = torch.stack([pos[u][:, None] == pos[v][None, :] for u in range(8)
                       for v in range(8)]).to(torch.uint8) * 255
    return torch.cat([top, 255 - top, torch.zeros((1, 8, 8), dtype=torch.uint8),
                      torch.full((1, 8, 8), 255, dtype=torch.uint8)])


@pytest.mark.parametrize("grid", [(1, 1), (5, 7), (16, 16), (282, 500)])
@pytest.mark.parametrize("table", ["all 1", "all 65535", "q90", "16-bit"])
def test_k7_matches_plain_on_flat_and_extreme_blocks(cuda, grid, table):
    gen = torch.Generator().manual_seed(grid[0] + grid[1] + len(table))
    hb, wb = grid
    b = 1 + (hb + wb) % 8
    n = b * hb * wb
    ext = _extreme_blocks()
    flat = (torch.randint(0, 2, (n,), generator=gen) * 255).to(torch.uint8)
    picks = torch.where(torch.arange(n) % 2 == 0, torch.arange(n) % len(ext),
                        len(ext) - 2 + flat.long() // 255)
    x = ext[picks].reshape(b, hb, wb, 8, 8).transpose(2, 3).reshape(b, hb * 8, wb * 8)
    q = {"all 1": np.ones(64), "all 65535": np.full(64, 65535),
         "q90": quality_tables(90)[0], "16-bit": _table(gen, True)}[table]
    x = x.to(cuda)
    got = cuda_dct.fdct_quantize_cuda(x, q)
    torch.cuda.synchronize()
    assert torch.equal(got, je.fdct_quantize_plain(x, q))


def test_k7_walks_tiles_beyond_the_grid_limit(cuda):
    # One block row 65535 * 128 + 777 blocks wide: more tiles of 128 block
    # columns than the grid's y holds, so each thread block walks a second.
    wb = 65535 * 128 + 777
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randint(0, 256, (1, 8, wb * 8), dtype=torch.uint8, device=cuda, generator=gen)
    q = quality_tables(75)[1]
    got = cuda_dct.fdct_quantize_cuda(x, q)
    torch.cuda.synchronize()
    for lo in range(0, wb * 8, 1 << 24):  # the plain version a slice at a time
        hi = min(lo + (1 << 24), wb * 8)
        assert torch.equal(got[:, :, lo // 8:hi // 8], je.fdct_quantize_plain(x[:, :, lo:hi], q))


def test_out_buffers_and_refused_tables(cuda):
    coefs = torch.zeros((2, 3, 4, 64), dtype=torch.int16, device=cuda)
    out = torch.empty((2, 24, 32), dtype=torch.uint8, device=cuda)
    assert cuda_dct.dequant_idct_cuda(coefs, np.ones(64), out=out) is out
    assert torch.equal(out, torch.full_like(out, 128))
    with pytest.raises(ValueError, match="1..65535"):
        cuda_dct.fdct_quantize_cuda(out, np.zeros(64))
    with pytest.raises(ValueError, match="aligned"):
        cuda_dct.fdct_quantize_cuda(out.view(-1)[1:1 + 2 * 24 * 8].view(2, 24, 8), np.ones(64))


@pytest.mark.parametrize("sub", je.DEVICE_SUBSAMPLINGS)
def test_encode_and_decode_planes_on_cuda_match_cpu(cuda, sub):
    rng = np.random.default_rng(len(sub))
    img = torch.from_numpy(rng.integers(0, 256, (3, 33, 29, 3), dtype=np.uint8))
    geo = je.encode_geometry(33, 29, 3, sub)
    luma, chroma = quality_tables(85)
    qts = [luma, chroma, chroma]
    want = je.encode_planes(geo, img, qts)
    got = je.encode_planes(geo, img.to(cuda), qts)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    dec_geo = jd.DecodeGeometry(*geo)
    assert torch.equal(jd.decode_planes(dec_geo, got, qts).cpu(),
                       jd.decode_planes(dec_geo, want, qts))


def test_transcode_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (4, 40, 56, 3), dtype=np.uint8))
    geo = je.encode_geometry(40, 56, 3, "420")
    luma, chroma = quality_tables(90)
    qts = [luma, chroma, chroma]
    qkey = tuple(tuple(int(v) for v in q) for q in qts)
    coefs = je.encode_planes(geo, img, qts)
    with ServingPipeline("blur3", device=cuda) as sp:
        got = sp.transcode_fn(geo, qkey)(*[c.to(cuda) for c in coefs])
    with ServingPipeline("blur3", device="cpu") as sp:
        want = sp.transcode_fn(geo, qkey)(*coefs)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
