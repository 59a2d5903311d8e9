"""The port's GlobalStatsPipeline and its runtime against hipe_tpu, exactly.

The pipeline in every layout and in chunks, its construction errors, the
device stream on CPU tensors, the engine (approach 1 on two CPU lanes;
approach 2 refuses), fleets, serving in all four placements of the codec
(with ``decode_gray`` too) and the CLI's ``--factor``, ``--cutoff`` and
``--preserve-tone``. hipe_tpu runs on the JAX CPU backend.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hipe_tpu.io_ import jpeg as hjpeg
from hipe_tpu.models import pipelines as jplib
from hipe_tpu.runtime.engine import Engine as JaxEngine
from hipe_tpu.runtime.engine import EngineConfig as JaxConfig
from hipe_tpu.runtime.serve import ServingPipeline as JaxServingPipeline
from hipe_tpu_torch import cli
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.parallel import mesh as tmesh
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner
from hipe_tpu_torch.runtime.engine import Engine, EngineConfig
from hipe_tpu_torch.runtime.fleet import FleetEngine, LaneSpec
from hipe_tpu_torch.runtime.serve import ServingPipeline

CPU = torch.device("cpu")
CONFIGS = {
    "equalize": {},
    "autocontrast": {},
    "autocontrast-cutoff2": {"cutoff": 2},
    "autocontrast-tone-1-5": {"cutoff": (1, 5), "preserve_tone": True},
    "contrast": {"factor": 1.5},
    "color": {"factor": 2.2},
    "sharpness": {"factor": 2.0},
    "mode": {},
    "mode5": {},
}


def _pipes(key, **extra):
    name = key.split("-")[0]
    kw = {**CONFIGS[key], **extra}
    return tplib.GlobalStatsPipeline(name, **kw), jplib.GlobalStatsPipeline(name, **kw)


def _images(b, h, w, c, seed):
    """Varied images: full range, a narrow range, few levels (real modes)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, h, w, c), np.uint8)
    x[1::3] = rng.integers(60, 90, x[1::3].shape)
    x[2::3] = rng.integers(0, 3, x[2::3].shape) * 120
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- the pipeline ----


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_pipeline_layouts_match_hipe_tpu(key, c):
    tp, jp = _pipes(key, channels=c)
    x = _images(3, 18, 27, c, seed=len(key) + c)
    want = np.asarray(jp.apply_nhwc(jnp.asarray(x), use_pallas=False))
    np.testing.assert_array_equal(tp.apply_nhwc(_t(x)).numpy(), want)
    np.testing.assert_array_equal(tp(_t(x)).numpy(), want)
    np.testing.assert_array_equal(tp(_t(x[0])).numpy(), want[0])  # no leading axis
    rows = tp.apply_rows(_t(x.reshape(3, 18, 27 * c)), c).numpy()
    np.testing.assert_array_equal(rows.reshape(x.shape), want)
    planes = x.transpose(0, 3, 1, 2).reshape(3 * c, 18, 27)
    got = tp.apply_planar(_t(planes)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jp.apply_planar(jnp.asarray(planes), use_pallas=False)))
    np.testing.assert_array_equal(got.reshape(3, c, 18, 27).transpose(0, 2, 3, 1), want)
    np.testing.assert_array_equal(np.stack([tp.oracle(im) for im in x]), want)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_chunked_apply_equals_one_call(monkeypatch, key):
    tp, _ = _pipes(key)
    x = _images(7, 16, 21, 3, seed=9)
    planes = _t(x.transpose(0, 3, 1, 2).reshape(21, 16, 21))
    whole = tp.apply_planar(planes)
    # Two images a chunk: four chunks, the last of one image.
    per_image = 3 * 16 * 21 * tplib.STATS_TEMP_BYTES[tp.name]
    monkeypatch.setattr(tplib, "STATS_CHUNK_BYTES", 2 * per_image + 1)
    assert tplib.global_stats_chunk(16, 21, 3, tp.name) == 6
    out = torch.full_like(planes, 7)
    assert tp.apply_planar(planes, out=out, rows_per_block=8, tile=(4, 4)) is out
    np.testing.assert_array_equal(out.numpy(), whole.numpy())
    np.testing.assert_array_equal(tp.apply_planar(planes).numpy(), whole.numpy())
    rows_out = torch.empty((7, 16, 63), dtype=torch.uint8)
    tp.apply_rows(_t(x.reshape(7, 16, 63)), 3, out=rows_out)
    np.testing.assert_array_equal(
        rows_out.numpy().reshape(7, 16, 21, 3).transpose(0, 3, 1, 2).reshape(21, 16, 21),
        whole.numpy())


def test_chunk_rule_takes_whole_images():
    assert tplib.global_stats_chunk(256, 256, 3, "equalize") % 3 == 0
    assert tplib.global_stats_chunk(256, 256, 3, "mode5") < tplib.global_stats_chunk(
        256, 256, 3, "equalize")
    # An image larger than the budget is still a chunk of its own.
    assert tplib.global_stats_chunk(40_000, 40_000, 3, "mode5") == 3


@pytest.mark.parametrize("kw", [
    dict(name="equalize", cutoff=2), dict(name="contrast", preserve_tone=True),
    dict(name="mode", factor=2.0), dict(name="autocontrast", cutoff=(60, 60)),
    dict(name="autocontrast", cutoff=2.5), dict(name="contrast", factor=-1.0),
    dict(name="color", factor="2"),
])
def test_construction_errors_match_hipe_tpu(kw):
    with pytest.raises(ValueError) as want:
        jplib.GlobalStatsPipeline(**kw)
    with pytest.raises(ValueError) as got:
        tplib.GlobalStatsPipeline(**kw)
    assert str(got.value) == str(want.value)


def test_no_radius_no_halo_mode_and_no_unknown_op():
    p = tplib.get("equalize")
    with pytest.raises(ValueError, match="no stencil radius.*item 9"):
        p.radius
    with pytest.raises(ValueError, match="halo"):
        p.apply_planar(torch.zeros((3, 4, 4), dtype=torch.uint8), h_pad=False)
    with pytest.raises(ValueError, match="multiple of 3 channels"):
        p.apply_rows(torch.zeros((1, 4, 8), dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="whole images"):
        tplib.get("contrast").apply_planar(torch.zeros((4, 4, 4), dtype=torch.uint8))
    with pytest.raises(KeyError, match="unknown global-statistics op"):
        tplib.GlobalStatsPipeline("nope")
    # No launch knob of its own at any size: one config, named after the route.
    assert p.launch_candidates(4000, 4000, "cpu") == [("torch_ops", {}, None)]


def test_package_exports_the_pipeline():
    import hipe_tpu_torch

    assert hipe_tpu_torch.GlobalStatsPipeline is tplib.GlobalStatsPipeline


# ---- the device stream on CPU tensors ----


@pytest.mark.parametrize("key", list(CONFIGS))
def test_stream_runner_matches_hipe_tpu(key):
    tp, jp = _pipes(key)
    image = _images(3, 20, 23, 3, seed=4)[2]  # few levels: modes, a narrow histogram
    r = DeviceStreamRunner(tp, num_images=3, image=image, device="cpu")
    assert r.config == {} and r.candidates == [("torch_ops", {}, None)]
    assert tp.launch_candidates(20, 23, "cpu") == r.candidates
    assert r._tune_key().endswith("|none") and tp.params in r._tune_key()
    assert r.verify_max_abs_err() == 0
    planes = jnp.asarray(r.stream.numpy())
    want = jp.apply_planar(jp.apply_planar(planes, use_pallas=False), use_pallas=False)
    np.testing.assert_array_equal(r.run_passes(2).numpy(), np.asarray(want))


def test_stream_runner_groups_a_gray_stream_by_its_channels():
    image = _images(1, 12, 9, 1, seed=2)[0]
    r = DeviceStreamRunner(tplib.GlobalStatsPipeline("contrast", factor=1.7), num_images=2,
                           image=image, device="cpu")
    assert r.pipeline.channels == 1 and r.verify_max_abs_err() == 0


# ---- the engine and fleets ----


@pytest.mark.parametrize("key", ["equalize", "autocontrast-cutoff2", "sharpness", "mode"])
def test_engine_approach1_matches_hipe_tpu(key):
    tp, jp = _pipes(key)
    batches = [_images(6, 16, 20, 3, seed=s) for s in (1, 2)]
    jd = jax.devices("cpu")
    kw = dict(approach=1, mode="both", gpu_ratio=0.5, batch_size=6, num_images=12)
    je = JaxEngine(JaxConfig(pipeline=jp, **kw), cpu_device=jd[0], accel_device=jd[1])
    js = je.run(stream=iter(batches))
    te = Engine(EngineConfig(pipeline=tp, **kw), cpu_device=CPU, accel_device=CPU)
    ts = te.run(stream=iter(batches))
    np.testing.assert_array_equal(te.first_output, je.first_output)
    assert (ts.cpu.images, ts.accel.images) == (js.cpu.images, js.accel.images)
    np.testing.assert_array_equal(te.first_output, np.stack([tp.oracle(im)
                                                             for im in batches[0]]))
    assert "PyTorch global-statistics ops" in te.report()


def test_engine_approach2_refuses_global_stats():
    te = Engine(EngineConfig(approach=2, gpu_ratio=0.5, batch_size=2, num_images=2,
                             pipeline="equalize"), cpu_device=CPU, accel_device=CPU)
    with pytest.raises(ValueError, match="no stencil radius"):
        te.run(image=_images(1, 8, 8, 3, seed=0)[0])


def test_fleets_run_approach1_and_refuse_row_split():
    img = _images(1, 20, 16, 3, seed=2)[0]
    lanes = [LaneSpec(CPU, weight=1.0, name=f"cpu{i}") for i in range(3)]
    eng = FleetEngine(lanes, approach=1, batch_size=6, num_images=12, pipeline="equalize")
    stats = eng.run(image=img)
    assert sum(c.images for c in stats.lanes) == 12
    np.testing.assert_array_equal(eng.first_output[0], tplib.get("equalize").oracle(img))
    rows = FleetEngine(lanes, approach=2, batch_size=6, num_images=6, pipeline="mode")
    with pytest.raises(ValueError, match="no stencil radius"):
        rows.run(image=img)


# ---- serving ----

STREAM = [hjpeg.encode_bytes_opts(_images(3, 33, 47, 3, seed=7)[i], 90, s)
          for i, s in enumerate(("420", "422", "420"))]
PLACEMENTS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("decode_gray", [False, True], ids=["rgb", "decode_gray"])
@pytest.mark.parametrize("key", ["equalize", "autocontrast-tone-1-5", "contrast", "color",
                                 "sharpness", "mode5"])
def test_serving_matches_hipe_tpu_in_every_placement(key, decode_gray):
    tp, jp = _pipes(key, channels=1 if decode_gray else 3)
    js = JaxServingPipeline(jp, use_pallas=False, decode_gray=decode_gray)
    want_px = js.process_batch(STREAM, encode=False)
    want = js.process_batch(STREAM)
    js.close()
    for dec, enc in PLACEMENTS:
        with ServingPipeline(tp, device=CPU, decode_on_device=dec, encode_on_device=enc,
                             decode_gray=decode_gray) as sp:
            for g, w in zip(sp.process_batch(STREAM, encode=False), want_px):
                np.testing.assert_array_equal(g, w, err_msg=f"pixels {dec} {enc}")
            assert sp.process_batch(STREAM) == want, (dec, enc)


@pytest.mark.parametrize("opts", [
    {"decode_scale": 4}, {"output_scale": 2}, {"resize_to": (20, 31)},
    {"gray_output": True, "colorize": ((0, 0, 128), (255, 224, 160))},
], ids=["decode_scale=4", "output_scale=2", "resize_to", "gray_output+colorize"])
@pytest.mark.parametrize("key", ["equalize", "contrast"])
def test_serving_options_match_hipe_tpu(key, opts):
    from hipe_tpu.ops import equalize as heq

    tp, jp = _pipes(key)
    if "colorize" in opts:
        opts = {**opts, "colorize": heq.colorize_lut(*opts["colorize"])}
    js = JaxServingPipeline(jp, use_pallas=False, **opts)
    want = js.process_batch(STREAM)
    js.close()
    for dec, enc in (PLACEMENTS[0], PLACEMENTS[-1]):
        with ServingPipeline(tp, device=CPU, decode_on_device=dec, encode_on_device=enc,
                             **opts) as sp:
            assert sp.process_batch(STREAM) == want, (dec, enc)


# ---- the CLI ----


@pytest.fixture
def cpu_as_accelerator(monkeypatch):
    """Discovery that offers the CPU as the accelerator too, so the CLI's
    two-lane programs run here."""
    inv = tmesh.DeviceInventory(cpu_devices=[CPU], accel_devices=[CPU],
                                accel_platform="cpu")
    monkeypatch.setattr(tmesh, "discover", lambda: inv)
    monkeypatch.setattr(cli, "gpu_name_and_power_limit", lambda: "a card, 700.00 W")


@pytest.mark.parametrize("argv,msg", [
    (["stream", "equalize", "--factor", "2"], "--factor applies"),
    (["stream", "contrast", "--factor", "1.5", "--cutoff", "2"], "--cutoff/--preserve-tone"),
    (["stream", "blur3", "--preserve-tone"], "--cutoff/--preserve-tone"),
    (["stream", "autocontrast", "--cutoff", "1", "2", "3"], "--cutoff/--preserve-tone"),
    (["stream", "autocontrast", "--cutoff", "60", "50"], "cutoff must be"),
    (["stream", "contrast", "--factor", "-1"], "factor must be"),
    (["stream", "equalize", "--image", "/nonexistent/x.jpg"], "cannot load input image"),
    (["serve", "mode", "--cutoff", "2", "--device", "cpu"], "--cutoff/--preserve-tone"),
    (["serve", "autocontrast", "--factor", "2", "--device", "cpu"], "--factor applies"),
    (["approach1", "cpu", "--pipeline", "blur3", "--factor", "2"], "--factor applies"),
    (["approach2", "--pipeline", "equalize"], "no stencil radius"),
    (["approach2", "--pipeline", "contrast", "--factor", "1.5"], "no stencil radius"),
])
def test_cli_stats_misuse_prints_one_error_line(argv, msg, capsys):
    assert cli.main(argv + ["--num-images", "2"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error:") and msg in err[0], err


@pytest.mark.parametrize("argv", [["stream", "equalize"], ["stream", "mode5"],
                                  ["stream", "autocontrast", "--cutoff", "2"],
                                  ["stream", "sharpness", "--factor", "2"]])
def test_cli_stream_without_cuda_raises(argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the stream would run")
    with pytest.raises(SystemExit, match="CUDA"):
        cli.main(argv + ["--num-images", "2"])


@pytest.mark.parametrize("argv,line", [
    (["serve", "autocontrast", "--cutoff", "2", "--preserve-tone"],
     "autocontrast (stages autocontrast), cutoff 2, preserve_tone"),
    (["serve", "contrast", "--factor", "1.5", "--decode-gray"],
     "contrast (stages contrast), factor 1.5"),
    (["serve", "equalize", "--decode-on-device", "--encode-on-device"],
     "equalize (stages equalize)"),
])
def test_cli_serve_runs_the_stats_pipelines(argv, line, capsys):
    assert cli.main(argv + ["--device", "cpu", "--num-images", "3", "--batch-size", "2",
                            "--json"]) == 0
    out = capsys.readouterr().out
    assert f"Pipeline: {line}" in out
    assert json.loads(out.strip().splitlines()[-1])["num_images"] == 3


@pytest.mark.parametrize("argv", [
    ["approach1", "cpu", "0.5", "2", "--pipeline", "contrast", "--factor", "1.5"],
    ["approach1", "both", "0.5", "2", "--pipeline", "autocontrast", "--cutoff", "1", "4"],
    ["approach1", "gpu", "1.0", "2", "--pipeline", "mode5"],
])
def test_cli_approach1_runs_the_stats_pipelines(cpu_as_accelerator, argv, capsys):
    assert cli.main(argv + ["--num-images", "4"]) == 0
    assert "All batches finished!" in capsys.readouterr().out
