"""The port's Pipeline against hipe_tpu's, exactly, for every ported pipeline."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hipe_tpu.models import pipelines as jplib
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops import blur as tblur

NAMES = ["blur3", "blur5", "blur7", "blur9", "sharpen", "edge", "chain",
         "median", "denoise", "erode", "dilate", "open", "close", "median5",
         "median7", "median9", "invert", "solarize", "posterize"]


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_apply_planar_matches_jax_pipeline(name, h_pad):
    x = _rng(1).integers(0, 256, (6, 32, 40), dtype=np.uint8)
    got = tplib.get(name).apply_planar(torch.from_numpy(x), h_pad=h_pad).numpy()
    jpipe = jplib.get(name)
    want_xla = np.asarray(jpipe.apply_planar(jnp.asarray(x), use_pallas=False, h_pad=h_pad))
    want_pallas = np.asarray(jpipe.apply_planar(
        jnp.asarray(x), use_pallas=True, interpret=True, h_pad=h_pad))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("name", NAMES)
def test_call_nhwc_matches_jax_pipeline(name):
    x = _rng(2).integers(0, 256, (2, 21, 19, 3), dtype=np.uint8)
    got = tplib.PIPELINES[name](torch.from_numpy(x)).numpy()
    want = jax.jit(jplib.PIPELINES[name])(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))


STATS_NAMES = ["equalize", "autocontrast", "contrast", "color", "sharpness", "mode", "mode5"]


def test_registry_and_radius():
    assert set(tplib.PIPELINES) == set(NAMES) | set(STATS_NAMES)
    for name in NAMES:
        assert tplib.get(name).radius == jplib.get(name).radius
        assert tplib.get(name).filters == jplib.get(name).filters
    for name in STATS_NAMES:
        with pytest.raises(ValueError, match="no stencil radius"):
            tplib.get(name).radius


@pytest.mark.parametrize("name", STATS_NAMES)
def test_stats_pipelines_equal_hipe_tpus(name):
    got, want = tplib.get(name), jplib.get(name)
    assert isinstance(got, tplib.GlobalStatsPipeline)
    assert isinstance(want, jplib.GlobalStatsPipeline)
    fields = ("name", "filters", "cutoff", "preserve_tone", "factor", "channels")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert tplib.get(got) is got


def test_unported_pipelines_raise():
    with pytest.raises(KeyError, match="unknown pipeline 'nope'"):
        tplib.get("nope")


@pytest.mark.parametrize("spec", ["gaussian5", ("gaussian3",), "edge", "posterize7",
                                  ["gaussian3", "sharpen", "edge"],
                                  ("posterize4", "gaussian9", "invert")])
def test_get_takes_bare_stages_and_stage_sequences(spec):
    got, want = tplib.get(spec), jplib.get(spec)
    assert (got.name, got.filters, got.radius) == (want.name, want.filters, want.radius)
    x = _rng(3).integers(0, 256, (3, 24, 29), dtype=np.uint8)
    np.testing.assert_array_equal(
        got.apply_planar(torch.from_numpy(x)).numpy(),
        np.asarray(want.apply_planar(jnp.asarray(x), use_pallas=True, interpret=True)))


@pytest.mark.parametrize("spec", [pytest.param(("mode",), id="mode"),
                                  ("gaussian3", "equalize"), ("nope",)])
def test_get_rejects_unported_and_unknown_stages(spec):
    # The global-statistics names are pipelines, not chainable stages.
    with pytest.raises(KeyError, match="unknown filter stage"):
        tplib.get(spec)


def test_every_hipe_tpu_pipeline_resolves_in_the_port():
    from hipe_tpu.ops import blur as jblur

    assert not hasattr(tplib, "UNPORTED_PIPELINES")
    assert set(tplib.PIPELINES) == set(jplib.PIPELINES)
    for name, want in jplib.PIPELINES.items():
        got = tplib.get(name)
        assert type(got).__name__ == type(want).__name__, name
        assert got.filters == want.filters, name
    # The global-statistics family is pipelines of their own, never stages.
    for name in STATS_NAMES:
        assert isinstance(jplib.PIPELINES[name], jplib.GlobalStatsPipeline), name
        assert name not in jblur.FILTERS and name not in tblur.FILTERS, name
