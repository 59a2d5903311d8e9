"""The mode filter's kernel K12 (``csrc/mode_planar.cu``) off the card.

The wrapper of ``ops/cuda_mode.py`` checks its call before any launch and
runs the plain version (the pairwise form, ``_mode_core``) on CPU tensors;
the pipeline names K12 as the mode filters' route on the card and gives
them one chunk there, and leaves the CPU's chunks as they were. The kernel
itself runs only on the card (``tests/test_torch_cuda_mode.py``).
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import cuda_mode as cm
from hipe_tpu_torch.ops import equalize as teq


def _planes(n, h, w, seed, levels=None):
    rng = np.random.default_rng(seed)
    if levels is None:
        return torch.from_numpy(rng.integers(0, 256, (n, h, w), np.uint8))
    return torch.from_numpy((rng.integers(0, levels, (n, h, w)) * 85).astype(np.uint8))


def _core(planes, size):
    """``_mode_core`` over the sentinel-padded int16 copy, as uint8."""
    r = size // 2
    n, h, w = planes.shape
    xp = torch.full((n, h + 2 * r, w + 2 * r), -1, dtype=torch.int16)
    xp[:, r:r + h, r:r + w] = planes
    return teq._mode_core(xp, size).to(torch.uint8)


_U8 = torch.uint8


@pytest.mark.parametrize("call", [
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 4), dtype=torch.int16)),
    lambda: cm.mode_planar_cuda(torch.zeros((8, 4), dtype=_U8)),
    lambda: cm.mode_planar_cuda(torch.zeros((1, 2, 4, 4), dtype=_U8)),
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 4), dtype=_U8), 7),
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 4), dtype=_U8), 4),
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 4), dtype=_U8, device="meta")),
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 8), dtype=_U8)[:, :, ::2]),
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 4), dtype=_U8),
                                out=torch.zeros((2, 4, 8), dtype=_U8)[:, :, ::2]),
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 4), dtype=_U8),
                                out=torch.zeros((2, 4, 5), dtype=_U8)),
    lambda: cm.mode_planar_cuda(torch.zeros((2, 4, 4), dtype=_U8),
                                out=torch.zeros((2, 4, 4), dtype=torch.int16)),
    lambda: (lambda buf: cm.mode_planar_cuda(buf[:32].view(2, 4, 4),
                                             out=buf[5:37].view(2, 4, 4)))(
        torch.zeros(40, dtype=_U8)),
    lambda: (lambda x: cm.mode_planar_cuda(x, out=x))(torch.zeros((2, 4, 4), dtype=_U8)),
], ids=["dtype", "rank-2", "rank-4", "size-7", "size-4", "device", "strided", "out-strided",
        "out-shape", "out-dtype", "out-partly-overlapping", "out-is-planes"])
def test_wrapper_raises_before_any_launch(call):
    before = cm.mode_planar_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        call()
    assert cm.mode_planar_cuda.launches == before


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape,levels", [((3, 13, 19), None), ((4, 17, 23), 3),
                                          ((2, 1, 7), 2), ((2, 6, 1), 4), ((1, 40, 53), 4)])
def test_cpu_route_is_the_pairwise_form(size, shape, levels):
    planes = _planes(*shape, seed=sum(shape) + size, levels=levels)
    planes[0, :2] = 0
    if shape[0] > 1:
        planes[-1] = 255
    before = cm.mode_planar_cuda.launches
    want = _core(planes, size)
    got = cm.mode_planar_cuda(planes, size)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(teq.mode_plain(planes, size), want)
    assert torch.equal(teq.mode_planar(planes, size=size), want)
    out = torch.empty_like(planes)
    assert cm.mode_planar_cuda(planes, size, out=out) is out and torch.equal(out, want)
    assert cm.mode_planar_cuda.launches == before  # the CPU launches nothing


def test_overlap_rule():
    buf = torch.zeros(64, dtype=torch.uint8)
    a, b = buf[:32].view(2, 4, 4), buf[32:].view(2, 4, 4)
    assert not cm.overlaps(a, b) and not cm.overlaps(b, a)
    assert cm.overlaps(a, a) and cm.overlaps(a, buf[31:63].view(2, 4, 4))
    assert cm.overlaps(buf[8:24].view(1, 4, 4), a)


@pytest.mark.parametrize("name", ["mode", "mode5"])
def test_launch_candidates_name_the_route(name):
    p = plib.GlobalStatsPipeline(name)
    for dev in ("cuda", torch.device("cuda", 0)):
        assert p.launch_candidates(240, 320, dev) == [("cuda_k12", {}, None)]
    assert p.launch_candidates(240, 320, "cpu") == [("torch_ops", {}, None)]
    assert plib.GlobalStatsPipeline("equalize").launch_candidates(
        240, 320, "cuda") == [("cuda_k8_k10", {}, None)]


@pytest.mark.parametrize("name", ["mode", "mode5"])
@pytest.mark.parametrize("hw", [(240, 320), (2250, 4000), (7, 5)])
def test_chunk_rule_one_chunk_on_the_card(name, hw):
    h, w = hw
    c = 3
    # The whole 5000-image stream is one chunk on the card.
    assert plib.global_stats_chunk(h, w, c, name, "cuda") >= 5000 * c
    # The CPU keeps whole images of the pairwise form's temporaries a pixel.
    before = c * max(1, plib.STATS_CHUNK_BYTES // (c * h * w * plib.STATS_TEMP_BYTES[name]))
    assert plib.global_stats_chunk(h, w, c, name) == before
    assert plib.global_stats_chunk(h, w, c, name, "cpu") == before
    if hw == (240, 320):
        # The CPU route's chunks of the stream's 15,000 planes: 26 for mode5, 16 for mode.
        chunks = -(-5000 * c // plib.global_stats_chunk(h, w, c, name, "cpu"))
        assert chunks == (26 if name == "mode5" else 16)
