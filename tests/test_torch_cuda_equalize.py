"""Equalize's kernels K8, K9 and K10 on the card, held bit for bit against
the plain PyTorch version on CPU tensors (skip without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_equalize.py -q

The identity cases (flat and two-value planes, ``step <= 0``), every value,
odd plane sizes at misaligned bases (the kernels' byte head and tail),
4000x2250 frames (planes cut across blocks), the stream's 15,000 planes of
240x320, ``out=`` contiguous and not, the rows and channels-last entries,
chained stream passes, and one launch of each kernel an equalize call.
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import cuda_equalize as ce
from hipe_tpu_torch.ops import equalize as teq
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _launches():
    return (ce.histogram_planes_cuda.launches, ce.equalize_lut_cuda.launches,
            ce.apply_lut_planar_cuda.launches)


def _plain(planes: torch.Tensor) -> torch.Tensor:
    """The plain version's equalize on CPU tensors."""
    return teq.equalize_planar(planes.cpu())


def _check(planes_cpu: torch.Tensor, dev: torch.device, base_offset: int = 0) -> None:
    """Histogram, tables and equalize of ``planes_cpu`` on the card (at
    ``base_offset`` bytes past an allocation) against the CPU."""
    n, h, w = planes_cpu.shape
    buf = torch.empty(base_offset + planes_cpu.numel(), dtype=torch.uint8, device=dev)
    planes = buf[base_offset:].view(n, h, w)
    planes.copy_(planes_cpu)
    before = _launches()
    hist = ce.histogram_planes_cuda(planes)
    lut = ce.equalize_lut_cuda(hist, h * w)
    got = ce.apply_lut_planar_cuda(planes, lut)
    eq = teq.equalize_planar(planes)
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 2 for b in before)
    want_hist = teq.histogram_planes(planes_cpu)
    assert torch.equal(hist.cpu(), want_hist)
    assert torch.equal(lut.cpu(), teq.equalize_lut(want_hist, h * w))
    want = _plain(planes_cpu)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(eq.cpu(), want)


def _rng_planes(n, h, w, seed, lo=0, hi=256):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, (n, h, w), np.uint8))


def test_flat_and_two_value_planes(cuda):
    """A flat plane (one populated bin) is the identity; a two-value plane
    maps its lower value to 0."""
    flat = torch.full((3, 40, 48), 77, dtype=torch.uint8)
    zeros = torch.zeros((2, 5, 7), dtype=torch.uint8)
    for planes in (flat, zeros):
        _check(planes, cuda)
        assert torch.equal(_plain(planes), planes)
    rng = np.random.default_rng(1)
    two = torch.from_numpy(np.where(rng.random((3, 40, 48)) < 0.7, 10, 200).astype(np.uint8))
    _check(two, cuda)
    assert int(_plain(two).min()) == 0


def test_last_bin_holds_almost_every_pixel(cuda):
    """step = (npix - last count) // 255 <= 0: the identity."""
    planes = torch.full((4, 32, 32), 250, dtype=torch.uint8)
    planes.view(4, -1)[:, :100] = _rng_planes(4, 1, 100, seed=2, hi=250).view(4, 100)
    _check(planes, cuda)
    assert torch.equal(_plain(planes), planes)


def test_every_value_and_overflowing_tables(cuda):
    ramp = torch.arange(256, dtype=torch.uint8).repeat(5 * 64).view(5, 64, 256)
    _check(ramp, cuda)
    a = torch.full((3, 256, 256), 200, dtype=torch.uint8)
    a.view(3, -1)[:, ::12] = _rng_planes(3, 1, 5462, seed=3, hi=21).view(3, 5462)
    _check(a, cuda)  # raw table entries past the last populated bin exceed 255


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 1, 1), (3, 1, 17), (4, 37, 53), (7, 3, 5),
                                   (2, 16, 16), (3, 240, 320)])
@pytest.mark.parametrize("offset", [0, 1, 7])
def test_odd_sizes_and_misaligned_bases(cuda, shape, offset):
    _check(_rng_planes(*shape, seed=sum(shape) + offset), cuda, base_offset=offset)


@pytest.mark.parametrize("n", [1, 3])
def test_large_frames_cut_across_blocks(cuda, n):
    rng = np.random.default_rng(n)
    base = rng.integers(0, 200, (n, 1, 1))
    x = (base + rng.integers(0, 56, (n, 2250, 4000))).astype(np.uint8)
    _check(torch.from_numpy(x), cuda)
    _check(torch.from_numpy(x), cuda, base_offset=3)


def test_the_streams_15000_planes(cuda):
    """The 5000-image 320x240 RGB stream in one call, against the plain
    version on the card in chunks of 1000 planes."""
    g = torch.Generator(device=cuda)
    g.manual_seed(16)
    n, h, w = 15000, 240, 320
    field = torch.linspace(30, 200, w, device=cuda).view(1, 1, w)
    noise = torch.randn((n, h, w), generator=g, device=cuda) * torch.linspace(
        1, 14, n, device=cuda).view(n, 1, 1)
    planes = (field + noise).clamp_(0, 255).to(torch.uint8)
    del noise
    before = _launches()
    got = teq.equalize_planar(planes)
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 1 for b in before)
    for i in range(0, n, 1000):
        blk = planes[i:i + 1000]
        want = teq.apply_lut(blk, teq.equalize_lut(teq.histogram_planes(blk), h * w))
        assert torch.equal(got[i:i + 1000], want)


def test_out_contiguous_in_place_and_strided(cuda):
    x = _rng_planes(6, 37, 53, seed=5, lo=40, hi=120)
    want = _plain(x)
    planes = x.to(cuda)
    out = torch.empty_like(planes)
    assert teq.equalize_planar(planes, out=out) is out
    assert torch.equal(out.cpu(), want)
    same = planes.clone()
    assert teq.equalize_planar(same, out=same) is same
    assert torch.equal(same.cpu(), want)
    big = torch.zeros((6, 37, 60), dtype=torch.uint8, device=cuda)
    view = big[:, :, 3:56]
    assert not view.is_contiguous()
    before = _launches()
    assert teq.equalize_planar(planes, out=view) is view
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 1 for b in before)
    assert torch.equal(view.cpu(), want)
    assert int(big[:, :, :3].sum()) == 0 and int(big[:, :, 56:].sum()) == 0
    # A non-contiguous input is made contiguous first.
    wide = x.to(cuda).transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(teq.equalize_planar(wide).cpu(), want)


def test_wrappers_raise_before_any_launch(cuda):
    planes = _rng_planes(2, 8, 8, seed=6).to(cuda)
    before = _launches()
    with pytest.raises(ValueError, match="contiguous"):
        ce.histogram_planes_cuda(planes.transpose(1, 2))
    with pytest.raises(ValueError, match="aligned"):
        ce.histogram_planes_cuda(planes, out=torch.empty(2 * 256 + 1, dtype=torch.int32,
                                                         device=cuda)[1:].view(2, 256))
    hist = ce.histogram_planes_cuda(planes)
    with pytest.raises(ValueError, match="aligned"):
        ce.equalize_lut_cuda(torch.empty(2 * 256 + 1, dtype=torch.int32,
                                         device=cuda)[1:].view(2, 256), 64)
    with pytest.raises(ValueError, match="overlaps"):
        flat = torch.empty(2 * 64 + 1, dtype=torch.uint8, device=cuda)
        ce.apply_lut_planar_cuda(flat[:128].view(2, 8, 8), ce.equalize_lut_cuda(hist, 64),
                                 out=flat[1:].view(2, 8, 8))
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1, before[2])


@pytest.mark.parametrize("c", [1, 3, 4])
def test_rows_and_channels_last(cuda, c):
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.integers(0, 256, (3, 29, 31, c), np.uint8))
    x[1] = x[1] // 16 + 100
    want = teq.equalize_nhwc(x)
    before = _launches()
    assert torch.equal(teq.equalize_nhwc(x.to(cuda)).cpu(), want)
    assert torch.equal(teq.equalize_rows(x.reshape(3, 29, 31 * c).to(cuda), c).cpu(),
                       want.reshape(3, 29, 31 * c))
    p = plib.GlobalStatsPipeline("equalize", channels=c)
    assert torch.equal(p.apply_nhwc(x.to(cuda)).cpu(), want)
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 3 for b in before)


def test_two_chained_stream_passes(cuda):
    rng = np.random.default_rng(9)
    image = np.clip(rng.normal(90, 9, (48, 64, 3)), 0, 255).astype(np.uint8)
    r = DeviceStreamRunner("equalize", num_images=40, image=image, device=cuda)
    cpu = DeviceStreamRunner("equalize", num_images=40, image=image, device="cpu")
    # The one autotune config is named after the route each takes.
    assert r.pipeline.launch_candidates(48, 64, cuda) == [("cuda_k8_k10", {}, None)]
    assert cpu.pipeline.launch_candidates(48, 64, "cpu") == [("torch_ops", {}, None)]
    assert r.candidates == r.pipeline.launch_candidates(48, 64, cuda)
    assert r.verify_max_abs_err() == 0
    before = _launches()
    got = r.run_passes(2)
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 2 for b in before)
    assert torch.equal(got.cpu(), cpu.run_passes(2))


@pytest.mark.parametrize("n", [1, 2, 7, 96, 528, 529, 3000])
def test_one_launch_each_at_any_n(cuda, n):
    x = _rng_planes(n, 24, 40, seed=n, lo=50, hi=180)
    before = _launches()
    got = teq.equalize_planar(x.to(cuda))
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 1 for b in before)
    assert torch.equal(got.cpu(), _plain(x))
    # The whole stream is one call of the pipeline on the card.
    assert plib.global_stats_chunk(24, 40, 3, "equalize", cuda) >= 3 * 5000
