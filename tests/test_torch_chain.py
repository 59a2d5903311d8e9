"""The port's band/point stages and fused chains against hipe_tpu, exactly.

Every comparison is exact (max-abs 0): uint8 in, integer arithmetic, uint8
out. The Pallas chain kernels run in interpret mode on the CPU, as
hipe_tpu's own tests run them: at H % 8 == 0 hipe_tpu routes a band chain to
kernel (c), ``_chain_mxu_kernel``, and at other H to kernel (d),
``_chain_kernel``; both give the same values, and so must the port.

The LUT registry is process-global in both packages, so every LUT
registered here carries a ``torchport_`` name no other test file uses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hipe_tpu.ops import blur as jblur
from hipe_tpu.ops import pallas_blur
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import reference as tref
from hipe_tpu_torch.ops import chain_program
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda

LUT_NAME = "torchport_dim"
LUT = jblur.brightness_lut(0.7)
for _reg in (jblur.register_lut_filter, tblur.register_lut_filter):
    _reg(LUT_NAME, LUT)

STAGES = ["sharpen", "edge", "invert", "solarize",
          *(f"posterize{b}" for b in range(1, 9)), LUT_NAME]
CHAINS = [
    ("gaussian3", "sharpen", "edge"),
    ("sharpen",),
    ("edge",),
    ("invert",),
    ("sharpen", "invert"),
    ("gaussian5", "solarize"),
    ("posterize4", "gaussian9", "edge"),
    ("gaussian7",),
    (LUT_NAME, "gaussian3"),
    ("posterize1", "edge"),
]
SHAPES = [(6, 32, 40), (4, 37, 53)]
# One compile per case instead of one dispatch per op.
_xla_chain_planar = jax.jit(
    lambda x, names, h_pad: jblur.filter_chain(x, names, h_axis=-2, w_axis=-1,
                                               h_pad=h_pad),
    static_argnums=(1, 2))


def _planes(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_hipe_tpu_planar_and_nhwc(name, h_pad):
    x = _planes((3, 19, 23), seed=len(name))
    got = tblur.FILTERS[name](torch.from_numpy(x), h_axis=-2, w_axis=-1, h_pad=h_pad)
    want = jblur.FILTERS[name](jnp.asarray(x), h_axis=-2, w_axis=-1, h_pad=h_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nhwc = _planes((2, 17, 13, 3), seed=len(name) + 1)
    got = tblur.FILTERS[name](torch.from_numpy(nhwc), h_pad=h_pad)
    want = jblur.FILTERS[name](jnp.asarray(nhwc), h_pad=h_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,oracle", [("sharpen", tref.sharpen3x3_oracle),
                                         ("edge", tref.sobel_edge_oracle)])
def test_sharpen_and_edge_match_the_oracles(name, oracle):
    from hipe_tpu.ops import reference as jref

    img = _planes((21, 18, 3), seed=5)
    got = tblur.FILTERS[name](torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, oracle(img))
    np.testing.assert_array_equal(oracle(img), getattr(jref, oracle.__name__)(img))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_chain_wrapper_matches_pallas_chain(names, h_pad, shape):
    x = _planes(shape, seed=len(names) + shape[1])
    got = filter_chain_planar_cuda(torch.from_numpy(x), names, h_pad=h_pad).numpy()
    want = pallas_blur.filter_chain_planar_pallas(
        jnp.asarray(x), names, h_pad=h_pad, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    want_xla = _xla_chain_planar(jnp.asarray(x), names, h_pad)
    np.testing.assert_array_equal(got, np.asarray(want_xla))


# int8 bands take only H % 8 == 0 and reject gaussian9's folded edge column.
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", [c for c in CHAINS if "gaussian9" not in c],
                         ids="+".join)
def test_chain_wrapper_matches_int8_band_chain(names, h_pad):
    x = _planes((6, 32, 40), seed=40 + len(names))
    got = filter_chain_planar_cuda(torch.from_numpy(x), names, h_pad=h_pad).numpy()
    want = pallas_blur.filter_chain_planar_pallas(
        jnp.asarray(x), names, h_pad=h_pad, int8_bands=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_radii_match_hipe_tpu():
    # Other test files may register port-only stages in the same process;
    # every test registration carries a torchport_ name.
    for name in tblur.FILTERS:
        if name in jblur.FILTERS:
            assert tblur.FILTER_RADIUS[name] == jblur.FILTER_RADIUS[name], name
        else:
            assert name.startswith("torchport_"), name
    assert tblur.FILTER_RADIUS[LUT_NAME] == jblur.FILTER_RADIUS[LUT_NAME] == 0
    for names in CHAINS:
        assert tblur.chain_radius(names) == jblur.chain_radius(names)
    # Every stage of hipe_tpu is ported (the rank family and the registered
    # kernels included), so no name needs reserving.
    builtin = (set(jblur.FILTERS) - set(jblur.LUT_STAGES)
               - (set(jblur.KERNEL_STAGES) - set(jblur.PIL_PRESETS))
               - (set(jblur.RANK_STAGES)
                  - {"median5", "erode5", "dilate5", "median7", "median9"}))
    assert builtin <= set(tblur.FILTERS)


@pytest.mark.parametrize("factor", [0, 0.7, 1.234, 2.5])
def test_brightness_lut_matches_hipe_tpu(factor):
    np.testing.assert_array_equal(tblur.brightness_lut(factor),
                                  jblur.brightness_lut(factor))


@pytest.mark.parametrize("gamma", [0.5, 2.2])
def test_gamma_lut_matches_hipe_tpu(gamma):
    np.testing.assert_array_equal(tblur.gamma_lut(gamma), jblur.gamma_lut(gamma))


@pytest.mark.parametrize("threshold", [0, 128, 256])
def test_solarize_lut_matches_hipe_tpu(threshold):
    np.testing.assert_array_equal(tblur.solarize_lut(threshold),
                                  jblur.solarize_lut(threshold))


def test_lut_registry_errors_match_hipe_tpu():
    for reg in (jblur.register_lut_filter, tblur.register_lut_filter):
        with pytest.raises(ValueError, match="256 entries"):
            reg("torchport_bad_len", np.arange(255))
        with pytest.raises(ValueError, match=r"\[0, 255\]"):
            reg("torchport_bad_range", np.arange(256) - 1)
        with pytest.raises(ValueError, match="builtin"):
            reg("invert", np.arange(256))
        reg("torchport_dup", np.arange(256))
        reg("torchport_dup", np.arange(256))  # the same LUT again: a no-op
        with pytest.raises(ValueError, match="different entries"):
            reg("torchport_dup", 255 - np.arange(256))
    # A hipe_tpu builtin the port does not carry yet stays reserved too.
    with pytest.raises(ValueError, match="builtin"):
        tblur.register_lut_filter("median", np.arange(256))


def test_stage_program_encoding():
    # The op codes are enum Op of csrc/chain_stages.cuh; a LUT used twice
    # is one table, indexed in order of first use.
    names = ("posterize4", LUT_NAME, "gaussian9", "edge", LUT_NAME, "posterize1",
             "sharpen", "invert", "solarize", "gaussian3", "posterize8")
    program, tables = chain_program.encode_band_program(names)
    assert program == [5, 0xF0, 6, 0, 0, 4, 2, 0, 6, 0, 5, 0x80,
                       1, 0, 3, 0, 4, 0, 0, 1, 5, 0xFF]
    assert len(tables) == 1
    np.testing.assert_array_equal(tables[0], LUT)


def test_wrapper_on_cpu_launches_nothing_and_rejects_bad_stages():
    x = torch.from_numpy(_planes((2, 12, 9), seed=50))
    want = tblur.filter_chain(x, CHAINS[0], h_axis=-2, w_axis=-1)
    out = torch.empty_like(x)
    assert filter_chain_planar_cuda(x, CHAINS[0], out=out) is out
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert filter_chain_planar_cuda.launches == 0
    with pytest.raises(KeyError, match="unknown"):
        filter_chain_planar_cuda(x, ("gaussian3", "nope"))
    with pytest.raises(KeyError, match="unknown filter stage"):
        filter_chain_planar_cuda(x, ("mode", "edge"))
    with pytest.raises(ValueError, match="valid mode"):
        filter_chain_planar_cuda(x, ("gaussian9", "gaussian5"), h_pad=False)
    with pytest.raises(ValueError, match="shares memory"):
        filter_chain_planar_cuda(x, ("edge",), out=x)
    with pytest.raises(TypeError):
        filter_chain_planar_cuda(x.int(), ("edge",))
    assert filter_chain_planar_cuda.launches == 0


def test_nhwc_chain_matches_hipe_tpu_xla_chain():
    x = _planes((2, 14, 11, 3), seed=60)
    names = ("gaussian3", "sharpen", "edge")
    got = tblur.filter_chain(torch.from_numpy(x), names).numpy()
    want = jax.jit(lambda a: jblur.filter_chain(a, names))(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))
