"""The port's Pipeline against hipe_tpu's, exactly, for every ported pipeline."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hipe_tpu.models import pipelines as jplib
from hipe_tpu_torch.models import pipelines as tplib

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


def test_registry_and_radius():
    assert set(tplib.PIPELINES) == set(NAMES)
    for name in NAMES:
        assert tplib.get(name).radius == jplib.get(name).radius
        assert tplib.get(name).filters == jplib.get(name).filters


@pytest.mark.parametrize("name", ["mode", "mode5", "autocontrast", "equalize", "nope"])
def test_unported_pipelines_raise(name):
    with pytest.raises(KeyError, match="ROADMAP.md"):
        tplib.get(name)


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


@pytest.mark.parametrize("spec", ["mode", ("gaussian3", "equalize"), ("nope",)])
def test_get_rejects_unported_and_unknown_stages(spec):
    with pytest.raises(KeyError, match="ROADMAP.md"):
        tplib.get(spec)


def test_unported_names_are_hipe_tpu_pipelines_or_stages():
    from hipe_tpu.ops import blur as jblur

    assert tplib.UNPORTED_PIPELINES <= set(jplib.PIPELINES) - set(tplib.PIPELINES)
    # Every pipeline of hipe_tpu is ported or named as still to port, and
    # what is still to port is the global-statistics family, no stage.
    for name in jplib.PIPELINES:
        assert (name in tplib.PIPELINES) != (name in tplib.UNPORTED_PIPELINES), name
    for name in tplib.UNPORTED_PIPELINES:
        assert isinstance(jplib.PIPELINES[name], jplib.GlobalStatsPipeline), name
        assert name not in jblur.FILTERS, name
