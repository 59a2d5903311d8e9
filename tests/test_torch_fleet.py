"""The port's N-lane fleet against hipe_tpu's FleetEngine, on the CPU.

Lanes on CPU devices passed explicitly (hipe_tpu's on virtual JAX CPU
devices, the port's on ``torch.device("cpu")``), over the same seeded
batches: the images mode (weights apportioned), the rows mode (weighted row
partition with halos, seams exact), double buffering, the greedy scheduler,
elastic survival of a killed lane, the run-stats view and the report.
"""

import time

import jax
import numpy as np
import pytest
import torch

from hipe_tpu.profiling.report import to_csv_row as jax_to_csv_row
from hipe_tpu.runtime.fleet import FleetEngine as JaxFleet
from hipe_tpu.runtime.fleet import LaneSpec as JaxLane
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.profiling.events import DeviceCounters
from hipe_tpu_torch.runtime.fleet import FleetEngine, LaneSpec

CPU = torch.device("cpu")


def _batches(n, bs, seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (min(bs, n - i), h, w, 3), dtype=np.uint8)
            for i in range(0, n, bs)]


def _pair(weights, batches, **kw):
    jd = jax.devices("cpu")
    jf = JaxFleet([JaxLane(jd[i], w, name=f"l{i}") for i, w in enumerate(weights)], **kw)
    js = jf.run(stream=batches)
    tf = FleetEngine([LaneSpec(CPU, w, name=f"l{i}") for i, w in enumerate(weights)], **kw)
    ts = tf.run(stream=batches)
    return jf, js, tf, ts


def _plain(batch, name="blur3"):
    return tplib.get(name)(torch.from_numpy(batch)).numpy()


def _lanes(stats):
    return [(c.name, c.images, c.units) for c in stats.lanes]


@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.2, 0.3, 0.5), (1.0, 0.0, 2.0)])
@pytest.mark.parametrize("name", ["blur3", "chain"])
def test_images_mode_equals_hipe_tpu(weights, name):
    batches = _batches(19, 7, seed=1)
    jf, js, tf, ts = _pair(weights, batches, approach=1, batch_size=7, num_images=19,
                           pipeline=name)
    np.testing.assert_array_equal(tf.first_output, jf.first_output)
    np.testing.assert_array_equal(tf.first_output, _plain(batches[0], name))
    assert _lanes(ts) == _lanes(js)


@pytest.mark.parametrize("weights", [(1.0, 2.0), (1.0, 2.0, 3.0), (0.01, 1.0, 0.01)])
@pytest.mark.parametrize("name", ["blur3", "chain", "denoise"])
def test_rows_mode_seams_equal_hipe_tpu(weights, name):
    batches = _batches(8, 4, seed=2)
    jf, js, tf, ts = _pair(weights, batches, approach=2, batch_size=4, num_images=8,
                           pipeline=name)
    np.testing.assert_array_equal(tf.first_output, jf.first_output)
    np.testing.assert_array_equal(tf.first_output, _plain(batches[0], name))
    assert _lanes(ts) == _lanes(js)
    assert sum(c.units for c in ts.lanes) == 8 * 24


@pytest.mark.parametrize("approach", [1, 2])
def test_depth_2_equals_hipe_tpu(approach):
    batches = _batches(16, 4, seed=3)
    jf, js, tf, ts = _pair((1.0, 3.0), batches, approach=approach, batch_size=4,
                           num_images=16, pipeline_depth=2)
    np.testing.assert_array_equal(tf.first_output, jf.first_output)
    assert _lanes(ts) == _lanes(js)


def test_greedy_takes_every_batch_once_and_matches_hipe_tpu():
    batches = _batches(30, 5, seed=4)
    jf, js, tf, ts = _pair((1.0, 1.0, 1.0), batches, approach=1, batch_size=5,
                           num_images=30, scheduler="greedy", profile=False)
    np.testing.assert_array_equal(tf.first_output, jf.first_output)
    assert sum(c.images for c in ts.lanes) == 30
    assert all(c.units == c.images for c in ts.lanes)


def _fleet(n, **kw):
    return FleetEngine([LaneSpec(CPU, name=f"l{i}") for i in range(n)], approach=1,
                       scheduler="greedy", profile=False, **kw)


@pytest.mark.parametrize("n_lanes", [2, 3])
def test_greedy_elastic_survives_a_killed_lane(n_lanes):
    batches = _batches(40, 4, seed=5)
    eng = _fleet(n_lanes, batch_size=4, num_images=40, elastic=True)

    def dead(batch):
        raise RuntimeError("device lost")

    eng._lanes[1].process = dead
    for lane in [ln for i, ln in enumerate(eng._lanes) if i != 1]:
        orig = lane.process

        def slow(batch, orig=orig):
            time.sleep(0.002)
            return orig(batch)

        lane.process = slow
    stats = eng.run(stream=batches)
    assert sum(c.images for c in stats.lanes) == 40
    assert stats.lanes[1].images == 0 and stats.lanes[1].total_ms == 0.0
    np.testing.assert_array_equal(eng.first_output, _plain(batches[0]))


@pytest.mark.parametrize("elastic", [False, True])
def test_greedy_raises_when_every_lane_fails(elastic):
    eng = _fleet(2, batch_size=4, num_images=16, elastic=elastic)

    def dead(batch):
        raise RuntimeError("device lost")

    for lane in eng._lanes:
        lane.process = dead
    with pytest.raises(RuntimeError, match="device lost"):
        eng.run(stream=_batches(16, 4, seed=6))


def test_greedy_on_approach_2_warns_and_defaults(capsys):
    eng = FleetEngine([LaneSpec(CPU), LaneSpec(CPU)], approach=2, scheduler="greedy",
                      elastic=True)
    assert eng.scheduler == "static" and eng.elastic is False
    assert capsys.readouterr().err.count("Warning:") == 2


@pytest.mark.parametrize("kw", [dict(approach=3), dict(scheduler="lottery")])
def test_bad_values_raise(kw):
    with pytest.raises(ValueError):
        FleetEngine([LaneSpec(CPU)], **kw)
    with pytest.raises(ValueError):
        FleetEngine([])


def test_run_stats_view_and_csv_row_equal_hipe_tpu():
    batches = _batches(12, 4, seed=7)
    jf, js, tf, ts = _pair((1.0, 3.0), batches, approach=1, batch_size=4, num_images=12)
    got, want = tf.to_run_stats(), jf.to_run_stats()
    # All lanes are CPU devices: one group, mode 'cpu', as in hipe_tpu.
    assert (got.mode, got.gpu_ratio, got.cpu.images, got.accel.images) == (
        want.mode, want.gpu_ratio, want.cpu.images, want.accel.images)
    assert (got.cpu_exec, got.accel_exec) == ("torch", "cuda")
    row, jrow = tf.to_csv_row(run=2, file="f"), jax_to_csv_row(want, run=2, file="f")
    for k in ("batch_size_file", "run", "file", "mode", "gpu_ratio_cfg", "images",
              "batches", "img_w", "img_h", "cpu_images", "gpu_images"):
        assert row[k] == jrow[k], k


def test_report_equals_hipe_tpu_for_the_same_stats():
    jd = jax.devices("cpu")
    jf = JaxFleet([JaxLane(jd[0], name="a"), JaxLane(jd[1], 2.0, name="b")])
    tf = FleetEngine([LaneSpec(CPU, name="a"), LaneSpec(CPU, 2.0, name="b")])
    for f in (jf, tf):
        f.stats.wall_ms = 812.5
        for c, (n, t) in zip(f.stats.lanes, ((100, 300.0), (400, 410.0))):
            c.images = c.units = n
            c.in_ms, c.kernel_ms, c.out_ms = t / 4, t / 2, t / 4
    assert tf.report() == jf.report()
    assert tf.stats.recommended_weights() == jf.stats.recommended_weights()
    assert tf.stats.imbalance_pct() == jf.stats.imbalance_pct()
    assert tf.stats.images_per_sec == jf.stats.images_per_sec


def test_recommended_weights_skip_lanes_without_work():
    tf = FleetEngine([LaneSpec(CPU), LaneSpec(CPU), LaneSpec(CPU)])
    for c, (n, t) in zip(tf.stats.lanes, ((10, 30.0), (0, 0.0), (10, 10.0))):
        c.images = c.units = n
        c.kernel_ms = t
    assert tf.stats.recommended_weights() == [0.25, 0.0, 0.75]
    assert isinstance(tf.stats.lanes[0], DeviceCounters)


def test_generator_stream_is_materialized_once():
    eng = FleetEngine([LaneSpec(CPU), LaneSpec(CPU)], approach=1, batch_size=4,
                      num_images=12)
    stats = eng.run(stream=(b for b in _batches(12, 4, seed=8)))
    assert sum(c.images for c in stats.lanes) == 12
