"""The mode filter's kernel K12 on the card, held bit for bit against the
plain PyTorch version (the pairwise form) on CPU tensors and against the
NumPy oracle (skip without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mode.py -q

Both sizes over ragged planes (every H and W of 1-5, 7, 40 and 53), the
stream's 240x320 and one 4000x2250 frame (cut into strips); uniform noise
(counts of at most 2: the centre pixel stays), quantized levels (ties: the
lowest value), constant planes, the values 0 and 255, plane counts that
fill no whole block; ``out=`` contiguous, strided and the input itself;
the pipeline's layouts and chained stream passes; one launch a call.
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import cuda_mode as cm
from hipe_tpu_torch.ops import equalize as teq
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

pytestmark = pytest.mark.cuda

SIDES = (1, 2, 3, 4, 5, 7, 40, 53)
KINDS = ("noise", "levels", "constant", "ends")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _planes(kind, n, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        x = rng.integers(0, 256, (n, h, w), np.uint8)
    elif kind == "levels":
        x = (rng.integers(0, 3, (n, h, w)) * 120).astype(np.uint8)
    elif kind == "constant":
        x = np.full((n, h, w), 77, np.uint8)
    else:  # "ends": the values 0 and 255 alone
        x = (rng.integers(0, 2, (n, h, w)) * 255).astype(np.uint8)
    return torch.from_numpy(x)


def _check(planes_cpu, size, dev):
    """K12 on the card against the CPU route, one launch."""
    before = cm.mode_planar_cuda.launches
    got = cm.mode_planar_cuda(planes_cpu.to(dev), size)
    torch.cuda.synchronize()
    assert cm.mode_planar_cuda.launches == before + 1
    want = teq.mode_plain(planes_cpu, size)
    assert torch.equal(got.cpu(), want), (size, tuple(planes_cpu.shape))
    return got.cpu()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", [3, 5])
def test_ragged_planes(cuda, size, kind):
    for h in SIDES:
        for w in SIDES:
            n = 1 + (h * w) % 5  # 1-5 planes: no whole block of columns
            _check(_planes(kind, n, h, w, seed=h * 100 + w), size, cuda)


@pytest.mark.parametrize("size", [3, 5])
def test_against_the_oracle(cuda, size):
    for i, kind in enumerate(KINDS):
        x = _planes(kind, 3, 40, 53, seed=i)
        got = _check(x, size, cuda)
        for p in range(3):
            np.testing.assert_array_equal(got[p].numpy(), teq.mode_oracle(x[p].numpy(), size))


def test_noise_keeps_the_centre_and_levels_take_the_lowest(cuda):
    """Uniform noise over 256 values mostly counts no value thrice: those
    pixels stay; two levels in equal shares tie, and the lower one wins."""
    x = _planes("noise", 2, 64, 96, seed=7)
    got = _check(x, 3, cuda)
    assert (got == x).float().mean() > 0.9
    # A 2x2 checker of 9 and 200: the 3x3 windows of the border rows and
    # columns hold 3 of each, a tie that 9 wins.
    tie = torch.tensor([[[9, 200], [200, 9]]], dtype=torch.uint8).repeat(1, 3, 3)
    got = _check(tie, 3, cuda)
    assert int(got[0, 0, 1]) == 9 and int(got[0, 1, 0]) == 9


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape", [(7, 240, 320), (1, 2250, 4000), (2, 517, 53),
                                   (3, 33, 1000)])
def test_stream_and_frame_shapes(cuda, size, shape):
    """The stream's planes (whole planes a thread's strip) and planes too
    few to fill the card (cut into strips), against the plain version on
    the card."""
    g = torch.Generator(device=cuda)
    g.manual_seed(sum(shape) + size)
    n, h, w = shape
    field = torch.linspace(30, 200, w, device=cuda).view(1, 1, w)
    noise = torch.randn((n, h, w), generator=g, device=cuda) * 6
    planes = ((field + noise) / 8).round_().mul_(8).clamp_(0, 255).to(torch.uint8)
    before = cm.mode_planar_cuda.launches
    got = teq.mode_planar(planes, size=size)
    torch.cuda.synchronize()
    assert cm.mode_planar_cuda.launches == before + 1
    for i in range(n):
        assert torch.equal(got[i:i + 1], teq.mode_plain(planes[i:i + 1], size)), i
    assert not torch.equal(got, planes)  # the filter did something


@pytest.mark.parametrize("size", [3, 5])
def test_out_contiguous_strided_and_in_place(cuda, size):
    x = _planes("levels", 6, 37, 53, seed=5)
    want = teq.mode_plain(x, size)
    planes = x.to(cuda)
    out = torch.empty_like(planes)
    before = cm.mode_planar_cuda.launches
    assert teq.mode_planar(planes, size=size, out=out) is out
    assert torch.equal(out.cpu(), want)
    same = planes.clone()
    assert teq.mode_planar(same, size=size, out=same) is same
    assert torch.equal(same.cpu(), want)
    big = torch.zeros((6, 37, 60), dtype=torch.uint8, device=cuda)
    view = big[:, :, 3:56]
    assert teq.mode_planar(planes, size=size, out=view) is view
    assert torch.equal(view.cpu(), want)
    assert int(big[:, :, :3].sum()) == 0 and int(big[:, :, 56:].sum()) == 0
    wide = planes.transpose(1, 2).contiguous().transpose(1, 2)  # not contiguous
    assert torch.equal(teq.mode_planar(wide, size=size).cpu(), want)
    torch.cuda.synchronize()
    assert cm.mode_planar_cuda.launches == before + 4


def test_wrapper_raises_before_any_launch(cuda):
    planes = _planes("noise", 2, 8, 8, seed=6).to(cuda)
    before = cm.mode_planar_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        cm.mode_planar_cuda(planes.transpose(1, 2))
    with pytest.raises(ValueError, match="overlaps"):
        flat = torch.empty(2 * 64 + 1, dtype=torch.uint8, device=cuda)
        cm.mode_planar_cuda(flat[:128].view(2, 8, 8), out=flat[1:].view(2, 8, 8))
    with pytest.raises(ValueError, match="overlaps"):
        cm.mode_planar_cuda(planes, out=planes)
    with pytest.raises(ValueError, match="on cpu"):
        cm.mode_planar_cuda(planes, out=torch.empty((2, 8, 8), dtype=torch.uint8))
    empty = torch.empty((0, 8, 8), dtype=torch.uint8, device=cuda)
    assert cm.mode_planar_cuda(empty, 5).shape == (0, 8, 8)
    assert cm.mode_planar_cuda.launches == before


@pytest.mark.parametrize("name", ["mode", "mode5"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_rows_and_channels_last(cuda, name, c):
    rng = np.random.default_rng(c)
    x = torch.from_numpy((rng.integers(0, 4, (3, 29, 31, c)) * 60).astype(np.uint8))
    size = 5 if name == "mode5" else 3
    want = teq.mode_nhwc(x, size=size)
    before = cm.mode_planar_cuda.launches
    assert torch.equal(teq.mode_nhwc(x.to(cuda), size=size).cpu(), want)
    assert torch.equal(teq.mode_rows(x.reshape(3, 29, 31 * c).to(cuda), c, size=size).cpu(),
                       want.reshape(3, 29, 31 * c))
    p = plib.GlobalStatsPipeline(name, channels=c)
    assert torch.equal(p.apply_nhwc(x.to(cuda)).cpu(), want)
    torch.cuda.synchronize()
    assert cm.mode_planar_cuda.launches == before + 3


@pytest.mark.parametrize("name", ["mode", "mode5"])
def test_two_chained_stream_passes(cuda, name):
    rng = np.random.default_rng(9)
    image = (rng.integers(0, 5, (48, 64, 3)) * 50).astype(np.uint8)
    r = DeviceStreamRunner(name, num_images=40, image=image, device=cuda)
    cpu = DeviceStreamRunner(name, num_images=40, image=image, device="cpu")
    # The one autotune config is named after the route each takes.
    assert r.candidates == [("cuda_k12", {}, None)]
    assert cpu.candidates == [("torch_ops", {}, None)]
    assert r.verify_max_abs_err() == 0
    before = cm.mode_planar_cuda.launches
    got = r.run_passes(2)
    torch.cuda.synchronize()
    assert cm.mode_planar_cuda.launches == before + 2  # the stream is one chunk a pass
    assert torch.equal(got.cpu(), cpu.run_passes(2))
