"""Kernel K11 (upsample + YCbCr -> RGB rows) on the card (skip without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ycc_rows.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import pytest
import torch

from hipe_tpu_torch.ops import cuda_dct
from hipe_tpu_torch.ops import jpeg_decode as jd

pytestmark = pytest.mark.cuda

SIZES = [(240, 320), (33, 41), (17, 23), (16, 16), (8, 8), (9, 9), (17, 32)]  # (H, W)
KINDS = ("random", "all 0", "all 255", "past the clamp")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _geometry(height, width, samplings, color=3):
    max_h, max_v = max(h for h, _ in samplings), max(v for _, v in samplings)
    comps = tuple((h, v, -(-width * h // (max_h * 8)), -(-height * v // (max_v * 8)))
                  for h, v in samplings)
    return jd.DecodeGeometry(width=width, height=height, ncomps=len(samplings), comps=comps,
                             max_h=max_h, max_v=max_v, color=color if len(samplings) == 4 else 3)


def _grid(shape, kind, gen, dev, offset=0):
    """A (B, rows, pitch) uint8 grid, contiguous, its first byte ``offset``
    bytes past an allocation's (aligned) start."""
    n = shape[0] * shape[1] * shape[2]
    if kind == "random":
        flat = torch.randint(0, 256, (n,), generator=gen, device=dev)
    elif kind == "past the clamp":  # 0s and 255s: R, G and B past both ends
        flat = torch.randint(0, 2, (n,), generator=gen, device=dev) * 255
    else:
        flat = torch.full((n,), 0 if kind == "all 0" else 255, device=dev)
    buf = torch.empty(n + offset, dtype=torch.uint8, device=dev)
    buf[offset:] = flat
    return buf[offset:].view(shape)


@pytest.mark.parametrize("batch", [1, 7, 853])
@pytest.mark.parametrize("fancy", [True, False], ids=["2x2", "1x1"])
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_k11_matches_plain(cuda, size, fancy, batch):
    h, w = size
    geo = _geometry(h, w, ((2, 2), (1, 1), (1, 1)) if fancy else ((1, 1),) * 3)
    assert jd.ycc_rows_fancy(geo, 1) is fancy
    dims = jd._scaled_down_dims(geo, 1, 8)
    gen = torch.Generator(device=cuda).manual_seed(h * 1000 + w + batch)
    for kind in KINDS:
        # Offset 1: unaligned bases take the kernel's any form.
        for offset in ((0, 1) if batch < 853 else (0,)):
            grids = [_grid((batch, hb * 8, wb * 8), kind, gen, cuda, offset)
                     for _, _, wb, hb in geo.comps]
            before = cuda_dct.ycc_rows_cuda.launches
            got = cuda_dct.ycc_rows_cuda(*grids, fancy, dims, size)
            torch.cuda.synchronize()
            assert cuda_dct.ycc_rows_cuda.launches == before + 1
            want = jd.ycc_rows_plain(*grids, fancy, dims, size)
            err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
            assert err == 0, (kind, offset)
            if kind == "past the clamp" and batch > 1:
                rgb = got.reshape(batch, h, w, 3)
                assert all(rgb[..., c].min() == 0 and rgb[..., c].max() == 255
                           for c in range(3))


def test_k11_writes_into_out(cuda):
    geo = _geometry(240, 320, ((2, 2), (1, 1), (1, 1)))
    gen = torch.Generator(device=cuda).manual_seed(5)
    grids = [_grid((3, hb * 8, wb * 8), "random", gen, cuda) for _, _, wb, hb in geo.comps]
    out = torch.full((3, 240, 960), 7, dtype=torch.uint8, device=cuda)
    assert cuda_dct.ycc_rows_cuda(*grids, True, (120, 160), (240, 320), out=out) is out
    assert torch.equal(out, jd.ycc_rows_plain(*grids, True, (120, 160), (240, 320)))


COVERED = {"4:2:0": (((2, 2), (1, 1), (1, 1)), 3, (1, 2, 4, 8)),
           "4:4:4": (((1, 1),) * 3, 3, (1,))}
UNCOVERED = {"4:2:2": (((2, 1), (1, 1), (1, 1)), 3),
             "4:4:0": (((1, 2), (1, 1), (1, 1)), 3),
             "CMYK": (((1, 1),) * 4, 4),
             "YCCK": (((2, 2), (1, 1), (1, 1), (2, 2)), 5),
             "gray": (((1, 1),), 3),
             "narrow 4:2:0": (((2, 2), (1, 1), (1, 1)), 3)}


def _coefs(geo, batch, gen, dev):
    out = []
    for _, _, wb, hb in geo.comps:
        c = torch.randint(-48, 48, (batch, hb, wb, 64), generator=gen, device=dev)
        c[..., 0] = torch.randint(-900, 900, (batch, hb, wb), generator=gen, device=dev)
        out.append(c.to(torch.int16))
    return out


def _decode_launches(geo, denom, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    coefs = _coefs(geo, 5, gen, dev)
    tables = [torch.randint(1, 64, (64,), generator=gen, device=dev).cpu() for _ in coefs]
    before = cuda_dct.ycc_rows_cuda.launches
    got = jd.decode_planes_scaled(geo, coefs, tables, denom, layout="rows")
    torch.cuda.synchronize()
    grew = cuda_dct.ycc_rows_cuda.launches - before
    want = jd.decode_planes_scaled(geo, [c.cpu() for c in coefs], tables, denom, layout="rows")
    assert torch.equal(got.cpu(), want)
    return grew


@pytest.mark.parametrize("name", COVERED)
def test_k11_launches_once_a_covered_decode(cuda, name):
    samplings, color, denoms = COVERED[name]
    for size in ((240, 320), (33, 41)):
        geo = _geometry(*size, samplings, color)
        for denom in denoms:
            assert jd.ycc_rows_fancy(geo, denom) is not None
            assert _decode_launches(geo, denom, cuda, seed=denom) == 1, (size, denom)


@pytest.mark.parametrize("name", UNCOVERED)
def test_k11_never_launches_on_other_geometries(cuda, name):
    samplings, color = UNCOVERED[name]
    size = (16, 4) if name.startswith("narrow") else (33, 41)
    geo = _geometry(*size, samplings, color)
    assert jd.ycc_rows_fancy(geo, 1) is None
    assert _decode_launches(geo, 1, cuda, seed=len(name)) == 0
