"""Equalize's kernels K8, K9, K10 (``csrc/equalize_planar.cu``) off the card.

The wrappers of ``ops/cuda_equalize.py`` check their calls before any
launch and run the plain version on CPU tensors, and the chunk rule gives
equalize one chunk on the card and leaves every other size as it was. The
kernels themselves run only on the card (``tests/test_torch_cuda_equalize.py``).
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import cuda_equalize as ce
from hipe_tpu_torch.ops import equalize as teq


def _launches():
    return (ce.histogram_planes_cuda.launches, ce.equalize_lut_cuda.launches,
            ce.apply_lut_planar_cuda.launches)


def _planes(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, h, w), np.uint8))


# ---- the wrappers ----


@pytest.mark.parametrize("call", [
    lambda: ce.histogram_planes_cuda(torch.zeros((2, 4, 4), dtype=torch.int16)),
    lambda: ce.histogram_planes_cuda(torch.zeros((8, 4), dtype=torch.uint8)),
    lambda: ce.histogram_planes_cuda(torch.zeros((2, 4, 4), dtype=torch.uint8),
                                     out=torch.zeros((3, 256), dtype=torch.int32)),
    lambda: ce.histogram_planes_cuda(torch.zeros((2, 4, 4), dtype=torch.uint8),
                                     out=torch.zeros((2, 256), dtype=torch.int64)),
    lambda: ce.equalize_lut_cuda(torch.zeros((2, 256), dtype=torch.int64), 16),
    lambda: ce.equalize_lut_cuda(torch.zeros((2, 4, 256), dtype=torch.int32), 16),
    lambda: ce.equalize_lut_cuda(torch.zeros((2, 255), dtype=torch.int32), 16),
    lambda: ce.equalize_lut_cuda(torch.zeros((2, 256), dtype=torch.int32), -1),
    lambda: ce.equalize_lut_cuda(torch.zeros((2, 256), dtype=torch.int32), 16,
                                 out=torch.zeros((2, 256), dtype=torch.int32)),
    lambda: ce.apply_lut_planar_cuda(torch.zeros((2, 4, 4), dtype=torch.float32),
                                     torch.zeros((2, 256), dtype=torch.uint8)),
    lambda: ce.apply_lut_planar_cuda(torch.zeros((2, 4, 4), dtype=torch.uint8),
                                     torch.zeros((3, 256), dtype=torch.uint8)),
    lambda: ce.apply_lut_planar_cuda(torch.zeros((2, 4, 4), dtype=torch.uint8),
                                     torch.zeros((2, 256), dtype=torch.uint8),
                                     out=torch.zeros((2, 4, 5), dtype=torch.uint8)),
    lambda: ce.apply_lut_planar_cuda(torch.zeros((2, 4, 4), dtype=torch.uint8),
                                     torch.zeros((2, 256), dtype=torch.uint8),
                                     out=torch.zeros((2, 4, 8), dtype=torch.uint8)[:, :, ::2]),
], ids=["hist-dtype", "hist-rank", "hist-out-shape", "hist-out-dtype", "lut-dtype",
        "lut-rank", "lut-bins", "lut-npix", "lut-out-dtype", "apply-dtype", "apply-lut-rows",
        "apply-out-shape", "apply-out-strided"])
def test_wrappers_raise_before_any_launch(call):
    before = _launches()
    with pytest.raises((TypeError, ValueError)):
        call()
    assert _launches() == before


def test_wrappers_on_cpu_tensors_are_the_plain_version():
    planes = _planes(5, 13, 19, seed=1)
    planes[2] = 9
    before = _launches()
    hist = ce.histogram_planes_cuda(planes)
    assert torch.equal(hist, teq.histogram_planes(planes))
    lut = ce.equalize_lut_cuda(hist, 13 * 19)
    assert torch.equal(lut, teq.equalize_lut(hist, 13 * 19))
    got = ce.apply_lut_planar_cuda(planes, lut)
    assert torch.equal(got, teq.apply_lut(planes, lut))
    assert torch.equal(got, teq.equalize_planar(planes))
    out = torch.empty_like(planes)
    assert ce.apply_lut_planar_cuda(planes, lut, out=out) is out and torch.equal(out, got)
    hist_out = torch.empty((5, 256), dtype=torch.int32)
    assert ce.histogram_planes_cuda(planes, out=hist_out) is hist_out
    assert _launches() == before  # the CPU launches nothing


# ---- the chunk rule ----


def test_chunk_rule_one_call_for_equalize_on_the_card():
    n, h, w, c = 5000, 240, 320, 3
    assert plib.global_stats_chunk(h, w, c, "equalize", "cuda") >= n * c
    assert plib.global_stats_chunk(h, w, c, "equalize", torch.device("cuda", 0)) >= n * c
    for name, temp in plib.STATS_TEMP_BYTES.items():
        # The rule before the card route: whole images of per-pixel temporaries.
        before = c * max(1, plib.STATS_CHUNK_BYTES // (c * h * w * temp))
        assert plib.global_stats_chunk(h, w, c, name) == before
        assert plib.global_stats_chunk(h, w, c, name, "cpu") == before
        if name not in plib.GlobalStatsPipeline.CARD_ROUTES:
            assert plib.global_stats_chunk(h, w, c, name, "cuda") == before
    # The CPU route's 7 chunks of the stream's 15,000 planes.
    assert -(-n * c // plib.global_stats_chunk(h, w, c, "equalize", "cpu")) == 7
