"""The global-statistics family on the card, held against the same ops on CPU
tensors (skip without CUDA).

This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_global_stats.py -q

Every op of ``GlobalStatsPipeline`` in each layout and in chunks; sharpness
launches K3 for its SMOOTH plane (K5 on planes too wide for K3), equalize
K8, K9 and K10 once each a call, and no other op launches a kernel; the
device stream, the engine's CUDA lane and the serving transcode with a
stats pipeline (K6 and K7 around it, from coefficients the port's encoder
makes: the card's machine has no libjpeg).
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.io_.jpeg import quality_tables
from hipe_tpu_torch.models import pipelines as plib
from hipe_tpu_torch.ops import cuda_dct, cuda_equalize, cuda_rank_chain, cuda_tiled
from hipe_tpu_torch.ops import jpeg_encode as je
from hipe_tpu_torch.ops import planar
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
from hipe_tpu_torch.runtime.engine import Engine, EngineConfig
from hipe_tpu_torch.runtime.serve import ServingPipeline

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
CONFIGS = {
    "equalize": {},
    "autocontrast": {},
    "autocontrast-cutoff2": {"cutoff": 2},
    "autocontrast-tone": {"cutoff": (1, 5), "preserve_tone": True},
    "contrast": {"factor": 1.5},
    "color": {"factor": 2.2},
    "sharpness": {"factor": 2.0},
    "mode": {},
    "mode5": {},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _pipe(key, **extra):
    return plib.GlobalStatsPipeline(key.split("-")[0], **CONFIGS[key], **extra)


def _images(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, h, w, c), np.uint8)
    x[1::3] = rng.integers(60, 90, x[1::3].shape)
    x[2::3] = rng.integers(0, 3, x[2::3].shape) * 120
    return torch.from_numpy(x)


def _launches():
    return (cuda_rank_chain.rank_chain_planar_cuda.launches,
            cuda_tiled.filter_stage_planar_tiled_cuda.launches)


def _equalize_launches():
    return (cuda_equalize.histogram_planes_cuda.launches,
            cuda_equalize.equalize_lut_cuda.launches,
            cuda_equalize.apply_lut_planar_cuda.launches)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_ops_on_the_card_equal_the_cpu(cuda, key, c):
    p = _pipe(key, channels=c)
    x = _images(4, 37, 53, c, seed=len(key) + c)
    k3, k5 = _launches()
    eqs = _equalize_launches()
    got = p.apply_nhwc(x.to(cuda))
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), p.apply_nhwc(x))
    planes = x.permute(0, 3, 1, 2).reshape(4 * c, 37, 53).contiguous()
    out = torch.empty_like(planes, device=cuda)
    assert p.apply_planar(planes.to(cuda), out=out) is out
    assert torch.equal(out.cpu(), p.apply_planar(planes))
    torch.cuda.synchronize()
    k3_now, k5_now = _launches()
    assert k3_now - k3 == (2 if p.name == "sharpness" else 0)
    assert k5_now == k5
    # Equalize launches K8, K9 and K10 once a call (one chunk each); no other op does.
    calls = 2 if p.name == "equalize" else 0
    assert _equalize_launches() == tuple(k + calls for k in eqs)


def test_sharpness_of_wide_planes_launches_k5(cuda):
    p = _pipe("sharpness")
    assert planar.routes_tiled(40, 4000, ("pil_smooth",))
    x = _images(1, 40, 4000, 3, seed=1)[0].permute(2, 0, 1).contiguous()
    k3, k5 = _launches()
    got = p.apply_planar(x.to(cuda))
    torch.cuda.synchronize()
    assert _launches() == (k3, k5 + 1)
    assert torch.equal(got.cpu(), p.apply_planar(x))


@pytest.mark.parametrize("key", ["equalize", "autocontrast-tone", "contrast", "sharpness",
                                 "mode5"])
def test_chunked_on_the_card_equals_one_call(cuda, monkeypatch, key):
    p = _pipe(key)
    x = _images(7, 33, 40, 3, seed=3).permute(0, 3, 1, 2).reshape(21, 33, 40).to(cuda)
    whole = p.apply_planar(x)
    # Two images a chunk on the card: four chunks, the last of one image.
    card = plib.GlobalStatsPipeline.CARD_ROUTES.get(p.name)
    per_plane = card[1] if card else 33 * 40 * plib.STATS_TEMP_BYTES[p.name]
    monkeypatch.setattr(plib, "STATS_CHUNK_BYTES", 2 * 3 * per_plane + 1)
    assert plib.global_stats_chunk(33, 40, 3, p.name, cuda) == 6
    assert torch.equal(p.apply_planar(x), whole)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_stream_runner_on_the_card(cuda, key):
    image = _images(3, 64, 48, 3, seed=5)[2].numpy()
    r = DeviceStreamRunner(_pipe(key), num_images=6, image=image, device=cuda)
    assert r.verify_max_abs_err() == 0
    cpu = DeviceStreamRunner(_pipe(key), num_images=6, image=image, device="cpu")
    assert torch.equal(r.run_passes(2).cpu(), cpu.run_passes(2))
    assert r.measure_throughput(passes=1, reps=1)["per_pass_s"] > 0


def test_engine_cuda_lane_runs_the_family(cuda):
    batches = [_images(6, 24, 32, 3, seed=s).numpy() for s in (1, 2)]
    for key in ("equalize", "sharpness", "mode"):
        kw = dict(approach=1, mode="both", gpu_ratio=0.5, batch_size=6, num_images=12,
                  pipeline=_pipe(key))
        card = Engine(EngineConfig(**kw), cpu_device=CPU, accel_device=cuda)
        card.run(stream=iter(batches))
        host = Engine(EngineConfig(**kw), cpu_device=CPU, accel_device=CPU)
        host.run(stream=iter(batches))
        assert card.stats.accel_exec == "cuda"
        np.testing.assert_array_equal(card.first_output, host.first_output)


@pytest.mark.parametrize("key", ["equalize", "autocontrast-cutoff2", "contrast"])
def test_transcode_with_a_stats_pipeline(cuda, key):
    img = _images(3, 41, 55, 3, seed=7)
    geo = je.encode_geometry(41, 55, 3, "420")
    luma, chroma = quality_tables(85)
    qts = [luma, chroma, chroma]
    qkey = tuple(tuple(int(v) for v in q) for q in qts)
    coefs = je.encode_planes(geo, img, qts)
    sps = [ServingPipeline(_pipe(key), device=d, decode_on_device=True, encode_on_device=True)
           for d in (cuda, CPU)]
    k6, k7 = cuda_dct.dequant_idct_cuda.launches, cuda_dct.fdct_quantize_cuda.launches
    got = sps[0].transcode_fn(geo, qkey)(*[c.to(cuda) for c in coefs])
    torch.cuda.synchronize()
    assert cuda_dct.dequant_idct_cuda.launches - k6 == 3
    assert cuda_dct.fdct_quantize_cuda.launches - k7 == 3
    want = sps[1].transcode_fn(geo, qkey)(*coefs)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for sp in sps:
        sp.close()
