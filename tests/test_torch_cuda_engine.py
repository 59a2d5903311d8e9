"""The heterogeneous engine's CUDA lane on the card (skips without CUDA).

Approach 1 and 2 with the CUDA lane on ``cuda:0`` against the plain chain
over distinct random images, with ratios that leave the CUDA slab 1-3 rows
tall; ``pipeline_depth=2`` equal to depth 1; and the launches of a run: one
of the path's kernel a CUDA-lane batch and one a warm-up shape, no other.
This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_engine.py -q
"""

import numpy as np
import pytest
import torch

from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_rows_cuda
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda, filter_chain_rows_cuda
from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
from hipe_tpu_torch.parallel import partitioner as pt
from hipe_tpu_torch.runtime.engine import Engine, EngineConfig
from hipe_tpu_torch.runtime.fleet import FleetEngine, LaneSpec

pytestmark = pytest.mark.cuda

H, W = 40, 48
WRAPPERS = {"K1 rows": gaussian_blur_rows_cuda, "K2": filter_chain_planar_cuda,
            "K2 rows": filter_chain_rows_cuda, "K3": rank_chain_planar_cuda}
KERNEL = {"blur3": "K1 rows", "chain": "K2", "denoise": "K3"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _batches(n, bs, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (min(bs, n - i), H, W, 3), dtype=np.uint8)
            for i in range(0, n, bs)]


def _plain(batches, name):
    x = torch.from_numpy(np.concatenate(batches))
    return tplib.get(name)(x).numpy()


def _run(cuda, batches, **kw):
    n = sum(len(b) for b in batches)
    eng = Engine(EngineConfig(num_images=n, batch_size=len(batches[0]), **kw),
                 cpu_device="cpu", accel_device=cuda)
    eng.run(stream=batches)
    return eng


def _gpu_rows(ratio, halo):
    return pt.row_split(H, ratio, halo=halo).gpu_output_rows


# Ratios that leave the CUDA lane's slab 1, 2 or 3 output rows (plus its
# halo), and the two extremes.
SLAB_RATIOS = [0.02, 0.05, 0.07, 0.5, 0.99, 1.0]


@pytest.mark.parametrize("name", ["blur3", "chain", "denoise"])
@pytest.mark.parametrize("ratio", SLAB_RATIOS)
def test_approach2_on_cuda_matches_plain(cuda, name, ratio):
    batches = _batches(12, 4, seed=int(ratio * 100))
    eng = _run(cuda, batches, approach=2, gpu_ratio=ratio, pipeline=name)
    np.testing.assert_array_equal(eng.first_output, _plain(batches[:1], name))
    assert eng.stats.accel_exec == "cuda"


def test_slab_ratios_leave_short_cuda_slabs():
    rows = {r: _gpu_rows(r, 1) for r in SLAB_RATIOS}
    assert {rows[0.02], rows[0.05], rows[0.07]} == {1, 2, 3}


@pytest.mark.parametrize("mode,ratio", [("gpu", 1.0), ("both", 0.3), ("both", 0.97)])
@pytest.mark.parametrize("name", ["blur3", "chain"])
def test_approach1_on_cuda_matches_plain(cuda, mode, ratio, name):
    batches = _batches(20, 7, seed=3)
    eng = _run(cuda, batches, approach=1, mode=mode, gpu_ratio=ratio, pipeline=name)
    np.testing.assert_array_equal(eng.first_output, _plain(batches[:1], name))


@pytest.mark.parametrize("approach", [1, 2])
def test_pipeline_depth_2_equals_depth_1(cuda, approach):
    batches = _batches(24, 4, seed=11)
    one = _run(cuda, batches, approach=approach, gpu_ratio=0.6, pipeline_depth=1)
    two = _run(cuda, batches, approach=approach, gpu_ratio=0.6, pipeline_depth=2)
    np.testing.assert_array_equal(one.first_output, two.first_output)
    assert one.stats.accel.images == two.stats.accel.images
    assert one.stats.accel.units == two.stats.accel.units


@pytest.mark.parametrize("kw,batches,warmups", [
    (dict(approach=1, mode="gpu", pipeline="blur3"), 3, 2),  # 8, 8, 4 images
    (dict(approach=1, mode="both", gpu_ratio=0.5, pipeline="blur3"), 3, 2),
    (dict(approach=2, gpu_ratio=0.5, pipeline="blur3"), 3, 2),
    (dict(approach=2, gpu_ratio=0.5, pipeline="chain"), 3, 2),
    (dict(approach=2, gpu_ratio=0.5, pipeline="denoise"), 3, 2),
])
def test_launches_of_a_run(cuda, kw, batches, warmups):
    stream = _batches(20, 8, seed=5)
    for fn in WRAPPERS.values():
        fn.launches = 0
    eng = _run(cuda, stream, **kw)
    kernel = KERNEL[kw["pipeline"]]
    counts = {k: fn.launches for k, fn in WRAPPERS.items()}
    assert counts == {k: (batches + warmups if k == kernel else 0) for k in WRAPPERS}
    np.testing.assert_array_equal(eng.first_output, _plain(stream[:1], kw["pipeline"]))


def test_fleet_greedy_with_a_cuda_lane(cuda):
    stream = _batches(40, 5, seed=9)
    fleet = FleetEngine([LaneSpec("cpu", name="cpu"), LaneSpec(cuda, name="cuda")],
                        approach=1, batch_size=5, num_images=40, scheduler="greedy")
    stats = fleet.run(stream=stream)
    assert sum(c.images for c in stats.lanes) == 40
    np.testing.assert_array_equal(fleet.first_output, _plain(stream[:1], "blur3"))
    assert fleet.to_run_stats().accel_exec == "cuda"


def test_engine_finds_the_card_by_itself(cuda):
    eng = Engine(EngineConfig(approach=1, mode="gpu", num_images=8, batch_size=4))
    assert eng.accel_device.type == "cuda" and "cpu" not in eng._lanes
    batches = _batches(8, 4, seed=1)
    eng.run(stream=batches)
    np.testing.assert_array_equal(eng.first_output, _plain(batches[:1], "blur3"))
