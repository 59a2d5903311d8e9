"""K4 and K5, the tiled route and the runner's tile sweep, against their
plain versions on the card (skips without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tiled.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
from hipe_tpu_torch.ops.cuda_tiled import (filter_chain_planar_tiled_cuda,
                                           filter_stage_planar_tiled_cuda,
                                           gaussian_blur_planar_tiled_cuda)
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

pytestmark = pytest.mark.cuda

LUT_NAME = "torchport_cuda_tiled_dim"
RANK_NAME = "torchport_cuda_tiled_q"
KERNEL_NAME = "torchport_cuda_tiled_tilt"
# Widths that are no multiple of 8 or 16 (300, 41, 70, 3, 1, 257, 1000 of
# 8 but not 16, 4001), and a 16-byte-aligned one (4000).
SHAPES = [(2, 47, 300), (1, 130, 41), (3, 2, 70), (2, 70, 3), (1, 1, 1), (1, 19, 257),
          (1, 9, 1000), (1, 6, 4001), (1, 5, 4000)]
# Odd tiles (two narrower than a run of 8), the autotune's, a tile wider
# than every plane; each test adds the full-width strip of its plane.
TILES = [(1, 1), (3, 5), (5, 7), (4, 4), (8, 128), (64, 512), (7, 8192)]
STAGES = ["sharpen", "edge", "invert", "solarize", "posterize2", LUT_NAME, "median",
          "erode", "dilate", "median5", RANK_NAME, "median7", "median9", "pil_emboss",
          "pil_smooth_more", KERNEL_NAME]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    tblur.register_lut_filter(LUT_NAME, tblur.brightness_lut(0.7))
    tblur.register_rank_filter(RANK_NAME, 5, 6)
    tblur.register_kernel_filter(KERNEL_NAME, range(-12, 13), 7, 2.5)
    return torch.device("cuda")


def _planes(cuda, shape, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda, generator=gen)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_k4_matches_plain(cuda, radius, h_pad, shape):
    if not h_pad and shape[1] <= 2 * radius:
        pytest.skip("valid mode needs H > 2r")
    x = _planes(cuda, shape, seed=radius)
    want = tblur.gaussian_blur_planar(x, radius, h_pad=h_pad)
    before = gaussian_blur_planar_tiled_cuda.launches
    tiles = TILES + [(16, shape[2])]
    for tile in tiles:
        got = gaussian_blur_planar_tiled_cuda(x, radius, tile=tile, h_pad=h_pad)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"tile={tile}"
    assert gaussian_blur_planar_tiled_cuda.launches == before + len(tiles)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("name", STAGES)
def test_k5_matches_plain(cuda, name, h_pad, shape):
    if not h_pad and shape[1] <= 2 * tblur.FILTER_RADIUS[name]:
        pytest.skip("valid mode needs H > 2r")
    x = _planes(cuda, shape, seed=len(name))
    want = tblur.FILTERS[name](x, h_axis=-2, w_axis=-1, h_pad=h_pad)
    before = filter_stage_planar_tiled_cuda.launches
    tiles = TILES + [(16, shape[2])]
    for tile in tiles:
        got = filter_stage_planar_tiled_cuda(x, name, tile=tile, h_pad=h_pad)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"tile={tile}"
    assert filter_stage_planar_tiled_cuda.launches == before + len(tiles)


def _offset_view(cuda, shape, seed):
    """Planes at storage offset 1: no row starts 16- or 8-byte aligned."""
    n = shape[0] * shape[1] * shape[2]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randint(0, 256, (n + 1,), dtype=torch.uint8, device=cuda,
                         generator=gen)[1:].view(shape)


@pytest.mark.parametrize("shape", [(2, 33, 64), (1, 20, 4000), (2, 11, 257)])
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("name", ["gaussian3", "gaussian9", *STAGES])
def test_tiled_kernels_at_storage_offset_1(cuda, name, h_pad, shape):
    """Input and output views at storage offset 1: the byte staging and
    byte stores; and each alone, against the aligned paths."""
    x = _offset_view(cuda, shape, seed=len(name))
    aligned = x.clone()
    want = tblur.FILTERS[name](x, h_axis=-2, w_axis=-1, h_pad=h_pad)
    out = torch.empty(want.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(want.shape)
    if name in tblur.GAUSSIANS:
        run = lambda src, **kw: gaussian_blur_planar_tiled_cuda(
            src, tblur.FILTER_RADIUS[name], h_pad=h_pad, **kw)
    else:
        run = lambda src, **kw: filter_stage_planar_tiled_cuda(src, name, h_pad=h_pad, **kw)
    for tile in ((5, 7), (16, 128), (8, shape[2])):
        for src, dst in ((x, out), (aligned, out), (x, None)):
            got = run(src, tile=tile, out=dst)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"tile={tile}"


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", [("gaussian3", "sharpen", "edge"), ("median", "gaussian3"),
                                   ("gaussian9", "gaussian5", "median9", LUT_NAME),
                                   ("erode",), ("invert", "gaussian7")], ids="+".join)
def test_tiled_chain_matches_plain_and_reuses_scratch(cuda, names, h_pad):
    x = _planes(cuda, (2, 61, 333), seed=len(names))
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    out = torch.empty_like(want)
    for tile in ((8, 128), (5, 7)):
        assert filter_chain_planar_tiled_cuda(x, names, tile=tile, h_pad=h_pad, out=out) is out
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"tile={tile}"
    # A chained second pass reads the first's output: the scratch buffers
    # never alias the caller's.
    again = filter_chain_planar_tiled_cuda(out, names, h_pad=True)
    assert torch.equal(again, tblur.filter_chain(want, names, h_axis=-2, w_axis=-1))


def test_oversized_planes_run_only_the_tiled_kernels(cuda):
    # 3500 wide: K2's and K3's 32-row tile needs 2 * 38 * 3520 B, over 227
    # KB, so chain and denoise run only K4 and K5; K1 takes no shared memory,
    # so blur3 stays on it.
    x = _planes(cuda, (1, 40, 3500), seed=3)
    counters = (filter_chain_planar_cuda, rank_chain_planar_cuda,
                gaussian_blur_planar_tiled_cuda)
    before = [fn.launches for fn in counters]
    for name in ("chain", "denoise"):
        pipe = tplib.get(name)
        assert pipe.routes_tiled(40, 3500)
        for h_pad in (True, False):
            want = tblur.filter_chain(x, pipe.filters, h_axis=-2, w_axis=-1, h_pad=h_pad)
            assert torch.equal(pipe.apply_planar(x, h_pad=h_pad), want)
    assert [fn.launches for fn in counters[:2]] == before[:2]
    assert counters[2].launches == before[2] + 4
    blur3, k1 = tplib.get("blur3"), gaussian_blur_planar_cuda.launches
    assert not blur3.routes_tiled(40, 3500)
    for h_pad in (True, False):
        want = tblur.filter_chain(x, blur3.filters, h_axis=-2, w_axis=-1, h_pad=h_pad)
        assert torch.equal(blur3.apply_planar(x, h_pad=h_pad), want)
    assert gaussian_blur_planar_cuda.launches == k1 + 2
    assert [fn.launches for fn in counters] == [before[0], before[1], before[2] + 4]


def test_tiled_kernels_refuse_what_they_do_not_take(cuda):
    x = _planes(cuda, (1, 20, 30), seed=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        gaussian_blur_planar_tiled_cuda(x, 1, tile=(512, 512))  # beyond shared memory
    with pytest.raises(ValueError, match="K4"):
        filter_stage_planar_tiled_cuda(x, "gaussian3")
    got = filter_stage_planar_tiled_cuda(x, "invert", tile=(4, 4))
    assert torch.equal(got, 255 - x)


def test_runner_sweeps_tiles_on_large_frames(cuda):
    image = np.random.default_rng(0).integers(0, 256, (64, 3500, 3), dtype=np.uint8)
    runner = DeviceStreamRunner("chain", num_images=2, image=image, device=cuda)
    assert runner.pipeline.routes_tiled(*runner.shape[:2])
    timings = runner.autotune(passes=1, reps=1)
    assert timings and all(label.startswith("cuda_tile") for label in timings)
    assert runner.config["tile"] in [c["tile"] for _, c, _ in runner.candidates]
    assert runner.verify_max_abs_err() == 0
    want = runner.stream
    for _ in range(2):
        want = tblur.filter_chain(want, runner.pipeline.filters, h_axis=-2, w_axis=-1)
    assert torch.equal(runner.run_passes(2), want)
