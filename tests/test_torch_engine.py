"""The port's heterogeneous engine against hipe_tpu's, on the CPU.

Both lanes run on CPU devices passed explicitly (hipe_tpu's on two virtual
JAX CPU devices, as ``tests/test_engine.py`` does; the port's on
``torch.device("cpu")``), over the same seeded batches of distinct images.
Batch 0's output and each lane's accounting (images, units, split row,
halo) must be equal: approach 1 static, greedy and double-buffered;
approach 2 at ratios 0 to 1 for blur3, chain and denoise, with the seam
checked against the whole-image chain; mixed-resolution streams. Also:
without CUDA, modes ``both`` and ``gpu`` raise unless the devices are
passed; the CLI's ``approach1`` and ``approach2``.
"""

import csv
import json

import jax
import numpy as np
import pytest
import torch

from hipe_tpu.profiling.report import to_csv_row as jax_to_csv_row
from hipe_tpu.runtime.engine import Engine as JaxEngine
from hipe_tpu.runtime.engine import EngineConfig as JaxConfig
from hipe_tpu.runtime.stream import MixedResolutionStream as JaxMixedStream
from hipe_tpu_torch import cli
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.parallel import mesh as tmesh
from hipe_tpu_torch.profiling.report import CSV_COLUMNS, render_report
from hipe_tpu_torch.runtime.engine import Engine, EngineConfig
from hipe_tpu_torch.runtime.stream import MixedResolutionStream
from hipe_tpu_torch.utils.images import checker_image

CPU = torch.device("cpu")


def _batches(n, bs, seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (min(bs, n - i), h, w, 3), dtype=np.uint8)
            for i in range(0, n, bs)]


def _pair(stream_of, **kw):
    """Run hipe_tpu's engine and the port's on the same config and stream."""
    jd = jax.devices("cpu")
    je = JaxEngine(JaxConfig(**kw), cpu_device=jd[0], accel_device=jd[1])
    js = je.run(stream=stream_of())
    te = Engine(EngineConfig(**kw), cpu_device=CPU, accel_device=CPU)
    ts = te.run(stream=stream_of())
    return je, js, te, ts


def _accounting(s):
    return (s.cpu.images, s.accel.images, s.cpu.units, s.accel.units, s.split_row,
            s.halo, s.num_batches, s.batch_size, s.height, s.width, s.channels)


A1_CASES = [
    dict(mode="both", gpu_ratio=0.6, batch_size=7, num_images=20),
    dict(mode="both", gpu_ratio=0.728, batch_size=8, num_images=16, pipeline="chain"),
    dict(mode="both", gpu_ratio=0.0, batch_size=8, num_images=16),
    dict(mode="cpu", batch_size=8, num_images=12),
    dict(mode="gpu", batch_size=5, num_images=12, pipeline="denoise"),
    dict(mode="both", gpu_ratio=0.4, batch_size=6, num_images=18, pipeline_depth=2),
    dict(mode="both", gpu_ratio=0.9, batch_size=8, num_images=16, pipeline_depth=3,
         profile=False),
]


@pytest.mark.parametrize("kw", A1_CASES)
def test_approach1_static_equals_hipe_tpu(kw):
    batches = _batches(kw["num_images"], kw["batch_size"], seed=1)
    je, js, te, ts = _pair(lambda: batches, approach=1, **kw)
    np.testing.assert_array_equal(te.first_output, je.first_output)
    assert _accounting(ts) == _accounting(js)
    name = kw.get("pipeline", "blur3")
    np.testing.assert_array_equal(
        te.first_output, tplib.get(name)(torch.from_numpy(batches[0])).numpy())


@pytest.mark.parametrize("name", ["blur3", "chain"])
def test_approach1_greedy_equals_hipe_tpu(name):
    batches = _batches(24, 4, seed=2)
    je, js, te, ts = _pair(lambda: batches, approach=1, mode="both", batch_size=4,
                           num_images=24, scheduler="greedy", pipeline=name)
    np.testing.assert_array_equal(te.first_output, je.first_output)
    # Which lane takes which batch follows the lanes' speed; every image
    # is taken once, and a lane's units are its images.
    assert ts.cpu.images + ts.accel.images == js.cpu.images + js.accel.images == 24
    assert (ts.cpu.units, ts.accel.units) == (ts.cpu.images, ts.accel.images)
    assert te.config.scheduler == "greedy"


@pytest.mark.parametrize("name", ["blur3", "chain", "denoise"])
@pytest.mark.parametrize("ratio", [0.0, 0.05, 0.5, 1.0])
def test_approach2_seam_equals_hipe_tpu(name, ratio):
    batches = _batches(12, 8, seed=3)
    je, js, te, ts = _pair(lambda: batches, approach=2, gpu_ratio=ratio, batch_size=8,
                           num_images=12, pipeline=name)
    np.testing.assert_array_equal(te.first_output, je.first_output)
    assert _accounting(ts) == _accounting(js)
    assert ts.halo == tplib.get(name).radius
    # The reassembled images equal the chain over whole images: the seam
    # (and each slab's halo rows, computed and dropped) is exact.
    np.testing.assert_array_equal(
        te.first_output, tplib.get(name)(torch.from_numpy(batches[0])).numpy())


@pytest.mark.parametrize("approach", [1, 2])
def test_pipeline_depth_2_equals_hipe_tpu(approach):
    batches = _batches(20, 4, seed=4)
    je, js, te, ts = _pair(lambda: batches, approach=approach, gpu_ratio=0.3,
                           batch_size=4, num_images=20, pipeline_depth=2)
    np.testing.assert_array_equal(te.first_output, je.first_output)
    assert _accounting(ts) == _accounting(js)


@pytest.mark.parametrize("approach", [1, 2])
def test_mixed_resolution_stream_equals_hipe_tpu(approach):
    images = [checker_image(24, 32, 3, seed=5), checker_image(17, 20, 3, seed=6)]
    jd = jax.devices("cpu")
    je = JaxEngine(JaxConfig(approach=approach, gpu_ratio=0.45, batch_size=4,
                             num_images=14), cpu_device=jd[0], accel_device=jd[1])
    js = je.run(stream=JaxMixedStream(images, 14, 4))
    te = Engine(EngineConfig(approach=approach, gpu_ratio=0.45, batch_size=4,
                             num_images=14), cpu_device=CPU, accel_device=CPU)
    ts = te.run(stream=MixedResolutionStream(images, 14, 4))
    np.testing.assert_array_equal(te.first_output, je.first_output)
    assert _accounting(ts) == _accounting(js)


def test_default_stream_is_the_reference_geometry():
    te = Engine(EngineConfig(approach=1, mode="cpu", batch_size=2, num_images=2))
    ts = te.run()
    assert (ts.height, ts.width, ts.channels) == (240, 320, 3)
    np.testing.assert_array_equal(
        te.first_output[1],
        tplib.get("blur3")(torch.from_numpy(checker_image(240, 320, 3, seed=0))).numpy())


def test_generator_stream_is_materialized_once():
    te = Engine(EngineConfig(approach=1, gpu_ratio=0.5, batch_size=4, num_images=12),
                cpu_device=CPU, accel_device=CPU)
    ts = te.run(stream=(b for b in _batches(12, 4, seed=7)))
    assert ts.cpu.images + ts.accel.images == 12


# ---- validation, modes and devices ----


@pytest.mark.parametrize("kw,field,value", [
    (dict(gpu_ratio=1.5), "gpu_ratio", 0.5),
    (dict(batch_size=0), "batch_size", 500),
    (dict(mode="tpu"), "mode", "gpu"),
    (dict(mode="accel"), "mode", "gpu"),
    (dict(approach=2, scheduler="greedy"), "scheduler", "static"),
    (dict(scheduler="greedy", pipeline_depth=2), "pipeline_depth", 1),
    (dict(elastic=True), "elastic", False),
])
def test_config_warns_and_defaults_like_hipe_tpu(kw, field, value, capsys):
    cfg = EngineConfig(**kw).validate()
    assert getattr(cfg, field) == value
    want = getattr(JaxConfig(**kw).validate(), field)
    assert value == ("gpu" if want == "tpu" else want)


@pytest.mark.parametrize("kw", [dict(approach=3), dict(mode="fpga"),
                                dict(scheduler="lottery"), dict(approach=2, mode="cpu")])
def test_config_rejects_bad_values(kw):
    with pytest.raises(ValueError):
        EngineConfig(**kw).validate()


@pytest.mark.parametrize("approach,mode", [(1, "both"), (1, "gpu"), (1, "tpu"), (2, "both")])
def test_without_cuda_the_cuda_lane_raises(approach, mode):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="no accel device found"):
        Engine(EngineConfig(approach=approach, mode=mode, num_images=4, batch_size=2))


def test_lanes_name_their_paths():
    te = Engine(EngineConfig(approach=1, mode="cpu", num_images=2, batch_size=2))
    assert list(te._lanes) == ["cpu"] and te.accel_device is None
    assert (te.stats.cpu_exec, te._lanes["cpu"].path) == ("torch", "torch")
    assert te.stats.accel_exec == "cuda"


def test_report_and_trace(tmp_path):
    te = Engine(EngineConfig(approach=1, gpu_ratio=0.5, batch_size=4, num_images=8,
                             trace_dir=str(tmp_path / "trace")),
                cpu_device=CPU, accel_device=CPU)
    ts = te.run(stream=_batches(8, 4, seed=8))
    text = te.report()
    assert text.startswith(render_report(ts, accel_name="CPU"))
    assert f"{torch.get_num_threads()} intra-op threads" in text
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_approach2_saves_image_0(tmp_path):
    batches = _batches(4, 4, seed=9)
    path = str(tmp_path / "out.jpg")
    te = Engine(EngineConfig(approach=2, gpu_ratio=0.7, batch_size=4, num_images=4,
                             save_output=path), cpu_device=CPU, accel_device=CPU)
    te.run(stream=batches)
    np.testing.assert_array_equal(tjpeg.decode_file(path),
                                  tjpeg.decode_bytes(tjpeg.encode_bytes(te.first_output[0])))


# ---- the CLI ----


@pytest.fixture
def cpu_as_accelerator(monkeypatch):
    """Discovery that offers the CPU as the accelerator too, so the CLI's
    two-lane programs run here (the card-only tests run them on CUDA)."""
    inv = tmesh.DeviceInventory(cpu_devices=[CPU], accel_devices=[CPU],
                                accel_platform="cpu")
    monkeypatch.setattr(tmesh, "discover", lambda: inv)
    monkeypatch.setattr(cli, "gpu_name_and_power_limit", lambda: "a card, 700.00 W")


@pytest.mark.parametrize("argv,cols", [
    (["approach1", "both", "0.5", "8"], dict(cpu_images=8, gpu_images=8)),
    (["approach1", "gpu", "0.3", "5", "--pipeline", "chain"],
     dict(cpu_images=0, gpu_images=16)),
    (["approach1", "both", "0.25", "4", "--scheduler", "greedy", "--elastic"], {}),
    (["approach2", "0.837", "8", "--pipeline", "gaussian3,edge"],
     dict(cpu_images=16, gpu_images=16)),
    (["approach2", "0.5", "6", "--pipeline-depth", "2", "--no-profile"],
     dict(cpu_images=16, gpu_images=16)),
])
def test_cli_approaches_print_the_report_and_a_csv_row(cpu_as_accelerator, tmp_path,
                                                       capsys, argv, cols):
    path = tmp_path / "runs.csv"
    for run in (1, 2):
        assert cli.main(argv + ["--num-images", "16", "--csv", str(path),
                                "--run-index", str(run)]) == 0
    out = capsys.readouterr().out
    for section in ("PERFORMANCE RESULTS", "1. OVERALL EXECUTION TIME", "7. THROUGHPUT",
                    "Card: a card, 700.00 W", "All batches finished!"):
        assert section in out
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == CSV_COLUMNS and [r["run"] for r in rows] == ["1", "2"]
    assert rows[0]["images"] == "16" and (rows[0]["img_w"], rows[0]["img_h"]) == ("320",
                                                                                   "240")
    for k, v in cols.items():
        assert rows[0][k] == str(v)


def test_cli_csv_counts_equal_hipe_tpu(cpu_as_accelerator, tmp_path):
    path = tmp_path / "runs.csv"
    assert cli.main(["approach2", "0.6", "8", "--num-images", "16", "--csv", str(path)]) == 0
    with open(path) as f:
        got = next(csv.DictReader(f))
    jd = jax.devices("cpu")
    je = JaxEngine(JaxConfig(approach=2, gpu_ratio=0.6, batch_size=8, num_images=16),
                   cpu_device=jd[0], accel_device=jd[1])
    want = jax_to_csv_row(je.run(image=checker_image(240, 320, 3, seed=0)))
    for k in ("batch_size_file", "mode", "gpu_ratio_cfg", "cpu_ratio_cfg", "images",
              "batches", "img_w", "img_h", "cpu_images", "gpu_images", "batch_size_log"):
        assert got[k] == str(want[k]), k
    assert (got["wg_w"], got["wg_h"]) == ("torch", "torch")


def test_cli_reads_jpeg_images(cpu_as_accelerator, tmp_path, capsys):
    a, b = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    tjpeg.encode_file(checker_image(24, 32, 3, seed=1), a)
    tjpeg.encode_file(checker_image(16, 20, 3, seed=2), b)
    out = str(tmp_path / "out.jpg")
    assert cli.main(["approach2", "0.5", "4", "--num-images", "8", "--image", f"{a},{b}",
                     "--save-output", out]) == 0
    assert "Original image loaded: 20x16, 3 channels" in capsys.readouterr().out
    assert tjpeg.decode_file(out).shape == (24, 32, 3)


@pytest.mark.parametrize("argv,msg", [
    (["approach1", "--pipeline", "nope"], "unknown pipeline"),
    (["approach2", "--pipeline", "gaussian3,equalize"], "unknown filter stage"),
    (["approach1", "cpu", "0.5", "2", "--image", "/nonexistent/x.jpg"],
     "cannot load input image"),
    (["approach1", "--rank", "torchport_engine_r=4:2"], "size must be odd"),
])
def test_cli_bad_input_prints_one_error_line(argv, msg, capsys):
    assert cli.main(argv + ["--num-images", "4"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error:") and msg in err[0], err


@pytest.mark.parametrize("flag", [["--factor", "1.5"], ["--cutoff", "2"],
                                  ["--preserve-tone"]])
def test_cli_stats_flags_name_the_roadmap(flag, capsys):
    # The flags set the global-statistics pipelines; on blur3 they are an error.
    assert cli.main(["approach1", "cpu", "--num-images", "4"] + flag) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error:") and "only" in err[0], err


@pytest.mark.parametrize("argv", [["approach1"], ["approach1", "gpu"], ["approach1", "tpu"],
                                  ["approach2", "0.9", "35"]])
def test_cli_without_cuda_fails(argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(SystemExit, match="no accel device found"):
        cli.main(argv + ["--num-images", "4"])


def test_cli_cpu_mode_runs_without_cuda(capsys):
    assert cli.main(["approach1", "cpu", "0.5", "2", "--num-images", "4"]) == 0
    out = capsys.readouterr().out
    assert "2. CPU DEVICE (processed 4 images)" in out and "3. GPU DEVICE" not in out
