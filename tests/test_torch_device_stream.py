"""The port's whole slice on the CPU, held exactly against hipe_tpu's runner.

The JAX runner's materialized stream is handed to the port's runner; after
chained passes the streams and the strided checksums must be equal. Also:
importing the port pulls in no JAX, and without CUDA the stream CLI and the
kernel build fail loudly instead of running on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hipe_tpu.runtime.device_stream import DeviceStreamRunner as JaxRunner
from hipe_tpu.utils.images import checker_image as jax_checker_image
from hipe_tpu_torch import cli
from hipe_tpu_torch.ops import _build
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
from hipe_tpu_torch.utils import images as timages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runner_pair(name):
    image = jax_checker_image(32, 40, 3)
    jr = JaxRunner(name, num_images=4, image=image, use_pallas=False)
    tr = DeviceStreamRunner(name, num_images=4, image=image, device="cpu",
                            stream=np.asarray(jr.stream))
    return jr, tr


@pytest.fixture(scope="module")
def runners():
    return _runner_pair("blur3")


@pytest.fixture(scope="module")
def chain_runners():
    return _runner_pair("chain")


def test_checker_image_and_layouts_match_hipe_tpu():
    from hipe_tpu.utils import images as jimages

    img = timages.checker_image(32, 40, 3, seed=7)
    np.testing.assert_array_equal(img, jimages.checker_image(32, 40, 3, seed=7))
    batch = np.stack([img, timages.checker_image(32, 40, 3, seed=8)])
    planes = timages.hwc_to_planar(batch)
    np.testing.assert_array_equal(planes, jimages.hwc_to_planar(batch))
    np.testing.assert_array_equal(timages.planar_to_hwc(planes, 3), batch)


def test_materialized_stream_matches_jax_runner(runners):
    jr, _ = runners
    own = DeviceStreamRunner("blur3", num_images=4, image=jr.image, device="cpu")
    np.testing.assert_array_equal(own.stream.numpy(), np.asarray(jr.stream))


@pytest.mark.parametrize("r", [1, 3])
def test_chained_passes_match_jax_runner(runners, r):
    jr, tr = runners
    import jax

    want_stream = np.asarray(jax.lax.fori_loop(
        0, r, lambda i, x: jr._one_pass(x), jr.stream))
    got_sum = tr.chained(r)
    np.testing.assert_array_equal(tr.run_passes(r).numpy(), want_stream)
    assert got_sum == jr._sync(jr._chained(jr.stream, r))
    # The stream itself is never overwritten by the passes.
    np.testing.assert_array_equal(tr.stream.numpy(), np.asarray(jr.stream))


def test_verify_max_abs_err_is_zero(runners):
    _, tr = runners
    assert tr.verify_max_abs_err() == 0


@pytest.mark.parametrize("r", [1, 3])
def test_chain_stream_passes_match_jax_runner(chain_runners, r):
    jr, tr = chain_runners
    import jax

    want_stream = np.asarray(jax.lax.fori_loop(
        0, r, lambda i, x: jr._one_pass(x), jr.stream))
    got_sum = tr.chained(r)
    np.testing.assert_array_equal(tr.run_passes(r).numpy(), want_stream)
    assert got_sum == jr._sync(jr._chained(jr.stream, r))
    np.testing.assert_array_equal(tr.stream.numpy(), np.asarray(jr.stream))


def test_chain_verify_max_abs_err_is_zero(chain_runners):
    jr, tr = chain_runners
    assert tr.pipeline.filters == jr.pipeline.filters == ("gaussian3", "sharpen", "edge")
    assert tr.verify_max_abs_err() == 0


def test_runner_rejects_a_stream_of_the_wrong_shape():
    image = timages.checker_image(8, 8, 3)
    with pytest.raises(ValueError, match="stream"):
        DeviceStreamRunner("blur3", num_images=2, image=image, device="cpu",
                           stream=np.zeros((5, 8, 8), np.uint8))


def test_runner_times_only_on_cuda(runners):
    _, tr = runners
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.measure_throughput(passes=1, reps=1)
    with pytest.raises(RuntimeError, match="no autotune config ran"):
        tr.autotune(passes=1, reps=1)


def test_importing_the_port_imports_no_jax():
    code = ("import sys, hipe_tpu_torch, hipe_tpu_torch.cli, "
            "hipe_tpu_torch.runtime.device_stream, hipe_tpu_torch.ops.cuda_blur, "
            "hipe_tpu_torch.ops.cuda_chain, hipe_tpu_torch.ops.cuda_rank_chain, "
            "hipe_tpu_torch.ops.cuda_tiled, hipe_tpu_torch.models.pipelines, "
            "hipe_tpu_torch.ops._build, hipe_tpu_torch.io_.jpeg, "
            "hipe_tpu_torch.ops.jpeg_decode, hipe_tpu_torch.ops.jpeg_encode, "
            "hipe_tpu_torch.ops.cuda_dct, hipe_tpu_torch.runtime.serve, "
            "hipe_tpu_torch.ops.resize, hipe_tpu_torch.ops.equalize, "
            "hipe_tpu_torch.ops.jpeg_transform, "
            "hipe_tpu_torch.runtime.engine, hipe_tpu_torch.runtime.fleet, "
            "hipe_tpu_torch.runtime.stream, hipe_tpu_torch.parallel.autotune, "
            "hipe_tpu_torch.parallel.mesh, hipe_tpu_torch.parallel.partitioner, "
            "hipe_tpu_torch.profiling.events, hipe_tpu_torch.profiling.report, "
            "hipe_tpu_torch.profiling.corpus, hipe_tpu_torch.utils.images; "
            "hipe_tpu_torch.DeviceStreamRunner, hipe_tpu_torch.PIPELINES, "
            "hipe_tpu_torch.filter_chain, hipe_tpu_torch.register_lut_filter, "
            "hipe_tpu_torch.register_rank_filter, "
            "hipe_tpu_torch.register_kernel_filter, hipe_tpu_torch.ServingPipeline, "
            "hipe_tpu_torch.decode_coefficients, hipe_tpu_torch.encode_bytes_device, "
            "hipe_tpu_torch.Engine, hipe_tpu_torch.EngineConfig, "
            "hipe_tpu_torch.FleetEngine, hipe_tpu_torch.LaneSpec; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('hipe_tpu.') or m == 'hipe_tpu' "
            "for m in sys.modules), 'hipe_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the CLI would run")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(["stream", "blur3", "--num-images", "2"])
    with pytest.raises(RuntimeError, match="is_available"):
        DeviceStreamRunner("blur3", num_images=2)


@pytest.mark.parametrize("argv", [
    ["stream", "chain", "--num-images", "2"],
    ["stream", "gaussian5", "--num-images", "2"],
    ["stream", "torchport_cli_dim,gaussian3,edge", "--num-images", "2",
     "--lut", "torchport_cli_dim=brightness:0.7"],
    ["stream", "denoise", "--num-images", "2"],
    ["stream", "median9", "--num-images", "2"],
    ["stream", "torchport_cli_q,edge", "--num-images", "2",
     "--rank", "torchport_cli_q=5:6"],
    ["stream", "torchport_cli_soft,sharpen", "--num-images", "2",
     "--kernel", "torchport_cli_soft=1,2,1,2,4,2,1,2,1:16"],
    ["stream", "torchport_cli_emb", "--num-images", "2",
     "--kernel", "torchport_cli_emb=-1,0,0,0,1,0,0,0,0:1:128"],
])
def test_cli_chains_without_cuda_raise(argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the CLI would run")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(argv)


@pytest.mark.parametrize("argv,msg", [
    (["stream", "nope"], "unknown pipeline"),
    (["stream", "gaussian3,equalize"], "unknown filter stage"),
    (["stream", "mode", "--factor", "2"], "--factor applies"),
    (["stream", "x,edge", "--lut", "x=brightness:-1"], "bad --lut"),
    (["stream", "edge", "--lut", "torchport_cli_bad=1,2,3"], "256 entries"),
    (["stream", "edge", "--rank", "torchport_cli_r=5:25"], "bad --rank"),
    (["stream", "edge", "--rank", "torchport_cli_r=4:2"], "size must be odd"),
    (["stream", "edge", "--rank", "torchport_cli_r5"], "expected NAME=SIZE:RANK"),
    (["stream", "edge", "--kernel", "torchport_cli_k=1,2,1:0"], "bad --kernel"),
    (["stream", "edge", "--kernel", "torchport_cli_k=1,2,x,4,5,6,7,8,9"], "bad --kernel"),
    (["stream", "edge", "--kernel", "torchport_cli_k=1,1,1,1,1,1,1,1,1:9:0.3"],
     "multiple of 0.5"),
    (["stream", "edge", "--kernel", "median=1,1,1,1,1,1,1,1,1"], "builtin"),
])
def test_cli_bad_names_and_luts_print_one_error_line(argv, msg, capsys):
    assert cli.main(argv) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error:") and msg in err[0], err


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
