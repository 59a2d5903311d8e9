"""The engine's support modules of the port against hipe_tpu's originals.

The partitioner, the stage clocks, the report, the CSV corpus and the input
streams are copies (the port may not import hipe_tpu): each is held equal
to its original, function for function. Also: device discovery, ratio
calibration's feedback loop, and the autotune winner kept on disk by
``DeviceStreamRunner`` (``stream --retune``).
"""

import contextlib
import csv
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hipe_tpu.parallel import autotune as jautotune
from hipe_tpu.parallel import mesh as jmesh
from hipe_tpu.parallel import partitioner as jpt
from hipe_tpu.profiling import corpus as jcorpus
from hipe_tpu.profiling import events as jevents
from hipe_tpu.profiling import report as jreport
from hipe_tpu.runtime import engine as jengine
from hipe_tpu.runtime import stream as jstream
from hipe_tpu.utils import images as jimages
from hipe_tpu_torch import cli
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.parallel import autotune as tautotune
from hipe_tpu_torch.parallel import mesh as tmesh
from hipe_tpu_torch.parallel import partitioner as tpt
from hipe_tpu_torch.profiling import corpus as tcorpus
from hipe_tpu_torch.profiling import events as tevents
from hipe_tpu_torch.profiling import report as treport
from hipe_tpu_torch.runtime import device_stream as tds
from hipe_tpu_torch.runtime import engine as tengine
from hipe_tpu_torch.runtime import stream as tstream
from hipe_tpu_torch.utils import images as timages

# Derandomized, with no example database: the same examples on every run.
FAST = settings(max_examples=150, deadline=None, derandomize=True, database=None)


# ---- partitioner ----


@FAST
@given(h=st.integers(1, 4000), ratio=st.floats(-0.5, 1.5, allow_nan=False),
       halo=st.integers(0, 9))
def test_row_split_and_ratio_math_equal_the_original(h, ratio, halo):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tpt.validate_ratio(ratio) == jpt.validate_ratio(ratio)
    r = tpt.validate_ratio(ratio, warn=False)
    assert dataclasses.asdict(tpt.row_split(h, r, halo)) == dataclasses.asdict(
        jpt.row_split(h, r, halo))
    assert tpt.split_images(h, r) == jpt.split_images(h, r)
    got, want = tpt.row_split(h, r, halo), jpt.row_split(h, r, halo)
    assert (got.cpu_input_rows, got.gpu_input_rows, got.cpu_output_rows,
            got.gpu_output_rows) == (want.cpu_input_rows, want.gpu_input_rows,
                                     want.cpu_output_rows, want.gpu_output_rows)
    warned = err.getvalue().splitlines()  # the port's warning, then the original's
    assert len(warned) in (0, 2) and len(set(warned)) <= 1


@FAST
@given(total=st.integers(1, 3000),
       weights=st.lists(st.floats(0.0, 10.0, allow_nan=False), min_size=1, max_size=6)
       .filter(lambda w: sum(w) > 0),
       halo=st.integers(0, 5))
def test_apportion_and_row_partition_equal_the_original(total, weights, halo):
    assert tpt.apportion(total, weights) == jpt.apportion(total, weights)
    if total >= len(weights):
        assert ([dataclasses.asdict(s) for s in tpt.row_partition(total, weights, halo)]
                == [dataclasses.asdict(s) for s in jpt.row_partition(total, weights, halo)])


@FAST
@given(times=st.lists(st.floats(-1.0, 50.0, allow_nan=False), min_size=1, max_size=6),
       batch=st.integers(-5, 6000), n=st.integers(1, 6000))
def test_recommendations_and_validation_equal_the_original(times, batch, n):
    # NaN where both give NaN (1/t overflows for subnormal t) counts as equal.
    np.testing.assert_array_equal(tpt.recommend_weights(times), jpt.recommend_weights(times))
    a, b = times[0], times[-1]
    np.testing.assert_array_equal(tpt.recommend_ratio(a, b), jpt.recommend_ratio(a, b))
    np.testing.assert_array_equal(tpt.imbalance_pct(a, b), jpt.imbalance_pct(a, b))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tpt.validate_batch(batch, n) == jpt.validate_batch(batch, n)
    warned = err.getvalue().splitlines()
    assert len(warned) in (0, 2) and len(set(warned)) <= 1
    assert tpt.num_batches(n, max(1, batch)) == jpt.num_batches(n, max(1, batch))


@pytest.mark.parametrize("h,n,halo", [(240, 4, 1), (256, 8, 3), (12, 3, 4)])
def test_even_row_shards_and_constants_equal_the_original(h, n, halo):
    assert tpt.even_row_shards(h, n, halo) == jpt.even_row_shards(h, n, halo)
    assert (tpt.DEFAULT_RATIO, tpt.DEFAULT_BATCH, tpt.NUM_IMAGES, tpt.MAX_BATCH) == (
        jpt.DEFAULT_RATIO, jpt.DEFAULT_BATCH, jpt.NUM_IMAGES, jpt.MAX_BATCH)


# ---- stage clocks, the report, the corpus ----


def _stats(mod, approach=1, mode="both", cpu=(35, 12.5, 230.25, 8.0),
           acc=(465, 40.0, 9.5, 60.75), split_row=None, batch=500, wall=913.4):
    """The same hand-built RunStats from ``mod`` (the port's or hipe_tpu's)."""
    s = mod.RunStats(approach=approach, mode=mode, gpu_ratio=0.93, batch_size=batch,
                     num_images=5000, num_batches=10, width=320, height=240, channels=3,
                     pipeline="blur3", wall_ms=wall, split_row=split_row,
                     halo=1 if split_row else None, cpu_exec="torch", accel_exec="cuda")
    for c, (n, tin, tk, tout) in ((s.cpu, cpu), (s.accel, acc)):
        c.images = c.units = n
        c.in_ms, c.kernel_ms, c.out_ms = tin, tk, tout
    return s


STATS = [dict(), dict(mode="cpu", acc=(0, 0.0, 0.0, 0.0)),
         dict(mode="gpu", cpu=(0, 0.0, 0.0, 0.0)),
         dict(approach=2, split_row=17, cpu=(5000, 1.0, 900.0, 2.0)),
         dict(cpu=(10, 0.0, 900.0, 0.0), acc=(490, 1.0, 0.5, 1.0), wall=0.0),
         dict(acc=(0, 0.0, 0.0, 0.0))]


@pytest.mark.parametrize("kw", STATS)
@pytest.mark.parametrize("accel_name", [None, "GPU", "CPU"])
def test_render_report_equals_the_original(kw, accel_name):
    got = (treport.render_report(_stats(tevents, **kw)) if accel_name is None
           else treport.render_report(_stats(tevents, **kw), accel_name=accel_name))
    want = jreport.render_report(_stats(jevents, **kw), accel_name=accel_name or "GPU")
    # The one difference: the re-run command names the port's module.
    assert got == want.replace("python -m hipe_tpu.cli", "python -m hipe_tpu_torch.cli")


@pytest.mark.parametrize("kw", STATS)
def test_csv_row_and_ratio_equal_the_original(kw):
    got = treport.to_csv_row(_stats(tevents, **kw), run=3, file="x.txt")
    assert got == jreport.to_csv_row(_stats(jevents, **kw), run=3, file="x.txt")
    assert list(got) == treport.CSV_COLUMNS == jreport.CSV_COLUMNS
    assert treport.recommended_ratio(_stats(tevents, **kw)) == jreport.recommended_ratio(
        _stats(jevents, **kw))


def test_run_stats_and_counters_equal_the_original():
    t, j = _stats(tevents), _stats(jevents)
    assert (t.images_per_sec, t.mpix_per_sec) == (j.images_per_sec, j.mpix_per_sec)
    for tc, jc in ((t.cpu, j.cpu), (t.accel, j.accel)):
        assert (tc.total_ms, tc.per_unit_ms(), tc.per_image_ms(), tc.pct(tc.in_ms)) == (
            jc.total_ms, jc.per_unit_ms(), jc.per_image_ms(), jc.pct(jc.in_ms))
    t.cpu.merge(t.accel)
    j.cpu.merge(j.accel)
    assert dataclasses.asdict(t.cpu) == dataclasses.asdict(j.cpu)
    # The port's defaults name its own paths and modes.
    fresh = tevents.RunStats(1, "gpu", 0.5, 1, 1, 1, 1, 1, 1, "blur3")
    assert (fresh.cpu_exec, fresh.accel_exec, fresh.cpu.name, fresh.accel.name) == (
        "torch", "cuda", "cpu", "accel")


def test_stage_clock_accounts_completed_stages_only():
    for mod in (tevents, jevents):
        c = mod.DeviceCounters("lane")
        clock = mod.StageClock(c)
        with clock.stage("in"):
            pass
        with pytest.raises(RuntimeError):
            with clock.stage("kernel"):
                raise RuntimeError("lost")
        with clock.stage("out"):
            pass
        assert c.in_ms >= 0 and c.out_ms >= 0 and c.kernel_ms == 0.0
    assert tevents.now_ms() <= jevents.now_ms()


def test_write_corpus_files_equal_the_original(tmp_path):
    runs = [dict(batch=35), dict(batch=35, wall=800.0), dict(batch=500, mode="gpu",
                                                            cpu=(0, 0.0, 0.0, 0.0))]
    got = tcorpus.write_corpus([_stats(tevents, **kw) for kw in runs],
                               str(tmp_path / "port"), accel_name="GPU")
    want = jcorpus.write_corpus([_stats(jevents, **kw) for kw in runs],
                                str(tmp_path / "orig"), accel_name="GPU")
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "orig").iterdir())
    assert names == ["35_run_1.txt", "35_run_2.txt", "500_run_1.txt", "avg_by_batch.csv",
                     "per_run.csv"]
    for name in names[:3]:
        got_log = (tmp_path / "port" / name).read_text()
        want_log = (tmp_path / "orig" / name).read_text()
        assert got_log == want_log.replace("hipe_tpu.cli", "hipe_tpu_torch.cli")
    with open(got[1]) as f:
        assert [r["runs"] for r in csv.DictReader(f)] == ["2", "1"]


def test_corpus_names_the_gpu_by_default(tmp_path):
    tcorpus.write_corpus([_stats(tevents)], str(tmp_path))
    assert "GPU DEVICE" in (tmp_path / "500_run_1.txt").read_text()


# ---- streams and images ----


@FAST
@given(n=st.integers(1, 3000), bs=st.integers(1, 700))
def test_batch_sizes_equal_the_original(n, bs):
    assert tstream.batch_sizes(n, bs) == jstream.batch_sizes(n, bs)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,bs", [(10, 4), (7, 7), (5, 9)])
def test_replicated_and_mixed_streams_equal_the_original(n, bs):
    img = timages.checker_image(6, 5, 3, seed=1)
    img2 = timages.checker_image(4, 9, 3, seed=2)
    t, j = tstream.ReplicatedStream(img, n, bs), jstream.ReplicatedStream(img, n, bs)
    _same_batches(t, j)
    assert t.batch_shapes() == j.batch_shapes()
    t = tstream.MixedResolutionStream([img, img2], n, bs)
    j = jstream.MixedResolutionStream([img, img2], n, bs)
    _same_batches(t, j)
    assert t.batch_shapes() == j.batch_shapes()
    _same_batches(tstream.Prefetcher(t, depth=1), j)
    assert tstream.Prefetcher(t).batch_shapes() == j.batch_shapes()
    np.testing.assert_array_equal(timages.replicate_stream(img, n),
                                  jimages.replicate_stream(img, n))


def test_prefetcher_raises_the_producers_error():
    def bad():
        yield np.zeros((1, 2, 2, 3), np.uint8)
        raise ValueError("corrupt payload")

    got = []
    with pytest.raises(ValueError, match="corrupt payload"):
        for b in tstream.Prefetcher(bad(), depth=1):
            got.append(b)
    assert len(got) == 1


def test_jpeg_stream_equals_the_original():
    payloads = [tjpeg.encode_bytes(timages.checker_image(16, 24, 3, seed=s), 90)
                for s in range(5)]
    t, j = tstream.JpegStream(payloads, 2), jstream.JpegStream(payloads, 2)
    _same_batches(t, j)
    assert t.batch_shapes() == j.batch_shapes() == [(2, 16, 24, 3), (2, 16, 24, 3),
                                                    (1, 16, 24, 3)]


def test_jpeg_files_round_trip(tmp_path):
    img = timages.checker_image(16, 24, 3, seed=3)
    path = str(tmp_path / "x.jpg")
    tjpeg.encode_file(img, path, quality=95)
    np.testing.assert_array_equal(tjpeg.decode_file(path),
                                  tjpeg.decode_bytes(tjpeg.encode_bytes(img, 95)))
    with pytest.raises(ValueError, match="only JPEG"):
        tjpeg.encode_file(img, str(tmp_path / "x.png"))
    (tmp_path / "y.jpg").write_bytes(b"P6 not a jpeg")
    with pytest.raises(ValueError, match="not a JPEG"):
        tjpeg.decode_file(str(tmp_path / "y.jpg"))


# ---- device discovery ----


def test_discovery_and_require_device_match_the_original():
    inv = tmesh.discover()
    assert inv.cpu_devices == [torch.device("cpu")]
    assert len(inv.accel_devices) == torch.cuda.device_count()
    assert tmesh.require_device(inv, "cpu") == torch.device("cpu")
    assert "Platform 0: torch-cpu (host)" in inv.describe()
    empty_t = tmesh.DeviceInventory(cpu_devices=[], accel_devices=[], accel_platform=None)
    empty_j = jmesh.DeviceInventory(cpu_devices=[], accel_devices=[], accel_platform=None)
    for kind in ("cpu", "accel"):
        with pytest.raises(RuntimeError) as got:
            tmesh.require_device(empty_t, kind)
        with pytest.raises(RuntimeError) as want:
            jmesh.require_device(empty_j, kind)
        assert str(got.value) == str(want.value)
    assert str(got.value) == "Error: no accel device found"


def test_discovery_without_cuda_finds_no_accelerator():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    inv = tmesh.discover()
    assert inv.accel_devices == [] and inv.accel_platform is None
    with pytest.raises(RuntimeError, match="no accel device found"):
        tmesh.require_device(inv, "accel")


# ---- ratio calibration ----

A_MS, B_MS = 3.0, 1.0


def _fake_engine(events_mod):
    class FakeEngine:
        """Lanes that cost A_MS (cpu) and B_MS (accel) an image, no noise."""

        def __init__(self, cfg, cpu_device=None, accel_device=None):
            self.cfg = cfg

        def run(self, image=None):
            cfg = self.cfg
            n = cfg.num_images
            n_gpu = int(round(cfg.gpu_ratio * n))
            s = events_mod.RunStats(approach=cfg.approach, mode=cfg.mode,
                                    gpu_ratio=cfg.gpu_ratio, batch_size=cfg.batch_size,
                                    num_images=n, num_batches=1, width=image.shape[1],
                                    height=image.shape[0], channels=image.shape[2],
                                    pipeline="blur3")
            s.cpu.units = s.cpu.images = n - n_gpu
            s.cpu.kernel_ms = (n - n_gpu) * A_MS
            s.accel.units = s.accel.images = n_gpu
            s.accel.kernel_ms = n_gpu * B_MS
            s.wall_ms = max(s.cpu.kernel_ms, s.accel.kernel_ms)
            return s

    return FakeEngine


@pytest.mark.parametrize("start,tol", [(0.5, 2.0), (0.1, 0.5), (0.9, 30.0)])
def test_calibrate_ratio_feedback_equals_the_original(monkeypatch, start, tol):
    monkeypatch.setattr(tautotune, "Engine", _fake_engine(tevents))
    monkeypatch.setattr(jautotune, "Engine", _fake_engine(jevents))
    img = timages.checker_image(8, 8, 3)
    got = tautotune.calibrate_ratio(tengine.EngineConfig(batch_size=16, num_images=64),
                                    img, start_ratio=start, tol_pct=tol)
    want = jautotune.calibrate_ratio(jengine.EngineConfig(batch_size=16, num_images=64),
                                     img, start_ratio=start, tol_pct=tol)
    assert got.history == want.history and got.ratio == want.ratio
    # One measured step reaches the fixed point a/(a+b) of the feedback.
    assert got.history[0][0] == start
    assert got.ratio in (start, A_MS / (A_MS + B_MS))
    if got.history[0][1] > tol:
        assert got.history[1][0] == A_MS / (A_MS + B_MS)


def test_sweep_tune_and_corpus_on_cpu_lanes(tmp_path):
    img = timages.checker_image(12, 16, 3, seed=0)
    base = tengine.EngineConfig(approach=1, mode="both", gpu_ratio=0.5, batch_size=8,
                                num_images=16)
    stats = tautotune.sweep_batch_sizes(base, img, batch_sizes=(4, 8), runs=2,
                                        cpu_device="cpu", accel_device="cpu")
    assert [s.batch_size for s in stats] == [4, 4, 8, 8]
    assert all(s.cpu.images + s.accel.images == 16 for s in stats)
    per_run, _ = tcorpus.write_corpus(stats, str(tmp_path))
    with open(per_run) as f:
        assert len(list(csv.DictReader(f))) == 4
    res = tautotune.tune(base, img, batch_sizes=(4, 8), calib_images=8,
                         cpu_device="cpu", accel_device="cpu")
    assert res.batch_size in (4, 8) and 0.0 <= res.ratio <= 1.0
    assert res.stats.images_per_sec > 0


# ---- the autotune winner on disk ----


def _runner(tmp_path, name="blur3"):
    return tds.DeviceStreamRunner(name, num_images=2, image=timages.checker_image(20, 24, 3),
                                  device="cpu", tune_cache_path=str(tmp_path / "tune.json"))


def _script(monkeypatch, runner, times):
    """Make each timing of ``runner`` return the next of ``times`` (seconds),
    or the time stored for its config label, and record what was timed."""
    seen = []

    def measure(passes, reps):
        label = f"cuda_rpb{runner.config['rows_per_block']}"
        seen.append(label)
        t = times(label)
        if t is None:
            raise RuntimeError("launch failed")
        return t

    monkeypatch.setattr(runner, "_measure_per_pass", measure)
    return seen


def test_tune_cache_stores_the_winner_and_hits(tmp_path, monkeypatch):
    r = _runner(tmp_path)
    labels = [lab for lab, _, why in r.candidates if why is None]
    seen = _script(monkeypatch, r, lambda lab: 1e-3 if lab == "cuda_rpb16" else 2e-3)
    r.autotune()
    assert seen == labels and r.tuning["chosen"] == "cuda_rpb16"
    assert r.tuning["cache_hit"] is False
    data = json.loads((tmp_path / "tune.json").read_text())
    assert list(data["entries"].values()) == [{"label": "cuda_rpb16", "per_pass_s": 1e-3}]
    assert "|blur3:gaussian3|20x24x3|n2|rows_per_block" in next(iter(data["entries"]))

    r2 = _runner(tmp_path)
    seen = _script(monkeypatch, r2, lambda lab: 1.5e-3)  # within 1.6x: kept
    timings = r2.autotune()
    assert seen == ["cuda_rpb16"] and timings == {"cuda_rpb16": 1.5e-3}
    assert r2.tuning["cache_hit"] is True and r2.config == {"rows_per_block": 16}
    # The stored time stays the fastest seen.
    stored = json.loads((tmp_path / "tune.json").read_text())["entries"]
    assert list(stored.values())[0]["per_pass_s"] == 1e-3


@pytest.mark.parametrize("fresh", [1.7e-3, None])
def test_tune_cache_sweeps_again_on_regression_or_failure(tmp_path, monkeypatch, fresh,
                                                          capsys):
    r = _runner(tmp_path)
    _script(monkeypatch, r, lambda lab: 1e-3 if lab == "cuda_rpb16" else 2e-3)
    r.autotune()
    r2 = _runner(tmp_path)
    n = len([1 for _, _, why in r2.candidates if why is None])
    calls = iter([fresh] + [3e-3] * (n - 1) + [0.5e-3])
    seen = _script(monkeypatch, r2, lambda lab: next(calls))
    r2.autotune()
    assert len(seen) == 1 + n and r2.tuning["cache_hit"] is False
    assert r2.tuning["chosen"] == seen[-1]
    assert ("regressed" if fresh else "failed") in capsys.readouterr().err
    stored = json.loads((tmp_path / "tune.json").read_text())["entries"]
    assert list(stored.values()) == [{"label": seen[-1], "per_pass_s": 0.5e-3}]


def test_retune_ignores_the_stored_winner(tmp_path, monkeypatch):
    r = _runner(tmp_path)
    _script(monkeypatch, r, lambda lab: 1e-3)
    r.autotune()
    r2 = _runner(tmp_path)
    seen = _script(monkeypatch, r2, lambda lab: 1e-3)
    r2.autotune(retune=True)
    assert len(seen) == len(r2.candidates) and r2.tuning["cache_hit"] is False
    r3 = _runner(tmp_path, "chain")  # another key: no hit
    seen = _script(monkeypatch, r3, lambda lab: 1e-3)
    r3.autotune()
    assert len(seen) == len(r3.candidates)


@pytest.mark.parametrize("content", ["{not json", '{"version": 0, "entries": {}}',
                                     '{"version": 1, "entries": {"k": 3}}', "[]"])
def test_a_broken_tune_cache_is_ignored(tmp_path, monkeypatch, content):
    (tmp_path / "tune.json").write_text(content)
    r = _runner(tmp_path)
    seen = _script(monkeypatch, r, lambda lab: 1e-3)
    r.autotune()
    assert len(seen) == len(r.candidates) and r.tuning["cache_hit"] is False


def test_tune_cache_default_lives_under_build():
    path = tds.default_tune_cache_path()
    assert path.endswith("build/hipe_tpu_torch/autotune.json")
    assert tds.RETUNE_FACTOR == 1.6


@pytest.mark.parametrize("argv,retune", [(["stream", "--retune"], True), (["stream"], False)])
def test_stream_cli_passes_retune(monkeypatch, argv, retune, capsys):
    calls = []

    class FakeRunner:
        def __init__(self, pipeline, **kw):
            self.tune_cache_path = "cache.json"
            self.tuning = None

        def autotune(self, retune=False):
            calls.append(retune)
            self.tuning = {"chosen": "cuda_rpb16", "cache_hit": not retune,
                           "skipped": {}}
            return {"cuda_rpb16": 1e-3}

        def verify_max_abs_err(self):
            return 0

        def measure_throughput(self, passes, reps):
            return {"per_pass_s": 1e-3, "img_per_s": 1.0, "mpix_per_s": 1.0,
                    "gb_per_s": 1.0}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tds, "DeviceStreamRunner", FakeRunner)
    monkeypatch.setattr(cli, "gpu_name_and_power_limit", lambda: "a card, 700 W")
    assert cli.main(argv + ["--num-images", "2"]) == 0
    assert calls == [retune]
    assert ("sweep skipped" in capsys.readouterr().out) is (not retune)
