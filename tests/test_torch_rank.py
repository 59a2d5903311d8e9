"""The port's rank, nonlinear and registered-kernel family against hipe_tpu, exactly.

Every comparison is exact (max-abs 0): uint8 in, integer arithmetic, uint8
out. Chains with a rank or registered-kernel stage run ``_chain_kernel``
(kernel (d)) in hipe_tpu; here it runs in interpret mode on the CPU, with
``int16_ranks`` off and on, as hipe_tpu's own tests run it. The port's
counterpart, kernel K3, runs only on the card: on the CPU its wrapper runs
the plain chain, which is what K3 is held against there.

The registries are process-global in both packages, so every stage
registered here carries a ``torchport_rank_`` name no other test file uses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hipe_tpu.ops import blur as jblur
from hipe_tpu.ops import pallas_blur
from hipe_tpu.runtime.device_stream import DeviceStreamRunner as JaxRunner
from hipe_tpu.utils.images import checker_image as jax_checker_image
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import chain_program, planar
from hipe_tpu_torch.ops.cuda_chain import filter_chain_planar_cuda
from hipe_tpu_torch.ops.cuda_rank_chain import rank_chain_planar_cuda
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

RANK_NAME = "torchport_rank_q"      # PIL RankFilter(5, 6)
KERNEL_NAME = "torchport_rank_k"    # asymmetric 5x5, negative taps, offset 2.5
LUT_NAME = "torchport_rank_dim"
KERNEL_TAPS = tuple(range(-12, 13))
for _mod in (jblur, tblur):
    _mod.register_rank_filter(RANK_NAME, 5, 6)
    _mod.register_kernel_filter(KERNEL_NAME, KERNEL_TAPS, 7, 2.5)
    _mod.register_lut_filter(LUT_NAME, jblur.brightness_lut(0.7))

BUILTIN_RANKS = ["median", "erode", "dilate", "median5", "erode5", "dilate5",
                 "median7", "median9"]
STAGES = [*BUILTIN_RANKS, *jblur.PIL_PRESETS, RANK_NAME, KERNEL_NAME]
CHAINS = [
    ("median", "gaussian3"),   # denoise
    ("erode", "dilate"),       # open
    ("dilate", "erode"),       # close
    ("median5", "edge"),
    ("pil_emboss", "gaussian3"),
    ("posterize4", "median9"),
    (RANK_NAME, "edge"),
    (LUT_NAME, KERNEL_NAME, "median"),
]
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


def _chain_cases():
    for names in CHAINS:
        for h_pad in (True, False):
            yield names, h_pad, False
            if jblur.rank_stage_names(names):
                yield names, h_pad, True


@pytest.mark.parametrize("names,h_pad,int16_ranks", list(_chain_cases()),
                         ids=lambda v: "+".join(v) if isinstance(v, tuple) else str(v))
def test_chain_wrapper_matches_chain_kernel(names, h_pad, int16_ranks):
    # H = 19: hipe_tpu would send even a band chain to _chain_kernel here.
    x = _planes((3, 19, 23), seed=len(names) + 7)
    got = rank_chain_planar_cuda(torch.from_numpy(x), names, h_pad=h_pad).numpy()
    want = pallas_blur.filter_chain_planar_pallas(
        jnp.asarray(x), names, h_pad=h_pad, interpret=True, int16_ranks=int16_ranks)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(_xla_chain_planar(jnp.asarray(x), names,
                                                                    h_pad)))


def test_kernel_presets_take_negative_numerators_to_zero():
    # The floor division meets negative numerators here (truncation would
    # round them up); the clip must still give hipe_tpu's value.
    x = _planes((2, 16, 16), seed=3)
    x[:, ::2, ::3] = 255
    for name in ("pil_find_edges", "pil_contour", "pil_emboss", KERNEL_NAME):
        spec = tblur.KERNEL_STAGES[name]
        v = tblur._stencil_r(torch.from_numpy(x), -2, -1, True, spec["radius"])
        num = 2 * tblur._kernel_acc(v, spec["flipped"], spec["size"]) \
            + spec["scale"] * (spec["off2"] + 1)
        assert bool((num < 0).any()), name
        got = tblur.FILTERS[name](torch.from_numpy(x), h_axis=-2, w_axis=-1).numpy()
        want = jblur.FILTERS[name](jnp.asarray(x), h_axis=-2, w_axis=-1)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_pil_presets_match_hipe_tpu():
    assert tblur.PIL_PRESETS == jblur.PIL_PRESETS
    for name in tblur.PIL_PRESETS:
        assert tblur.KERNEL_STAGES[name] == jblur.KERNEL_STAGES[name], name
        assert tblur.FILTER_RADIUS[name] == jblur.FILTER_RADIUS[name], name
    for name in BUILTIN_RANKS[3:]:
        assert tblur.RANK_STAGES[name] == jblur.RANK_STAGES[name], name


def _error(register, *args):
    with pytest.raises(ValueError) as e:
        register(*args)
    return str(e.value)


@pytest.mark.parametrize("args", [
    ("torchport_rank_bad", 4, 2),
    ("torchport_rank_bad", 11, 2),
    ("torchport_rank_bad", 5, -1),
    ("torchport_rank_bad", 5, 25),
    (RANK_NAME, 5, 7),          # a conflicting spec
    ("median", 3, 4),           # builtin names, of every kind
    ("pil_emboss", 3, 4),
    ("invert", 3, 4),
    (LUT_NAME, 3, 4),
], ids=str)
def test_rank_registry_errors_match_hipe_tpu(args):
    assert _error(tblur.register_rank_filter, *args) == _error(
        jblur.register_rank_filter, *args)


@pytest.mark.parametrize("args", [
    ("torchport_rank_kbad", (1,) * 8),
    ("torchport_rank_kbad", (1,) * 4),
    ("torchport_rank_kbad", (1,) * 121),
    ("torchport_rank_kbad", (1, -1, 0) * 3),          # sum 0: no default scale
    ("torchport_rank_kbad", (1,) * 9, -2),
    ("torchport_rank_kbad", (1,) * 9, 1.5),
    ("torchport_rank_kbad", (1,) * 9, 9, 0.3),
    ("torchport_rank_kbad", (4000,) * 9, 1),          # beyond the exact bound
    (KERNEL_NAME, KERNEL_TAPS, 7, 3.0),               # a conflicting spec
    ("median5", (1,) * 9),                            # builtin names
    ("gaussian3", (1,) * 9),
    (RANK_NAME, (1,) * 9),
])
def test_kernel_registry_errors_match_hipe_tpu(args):
    assert _error(tblur.register_kernel_filter, *args) == _error(
        jblur.register_kernel_filter, *args)


@pytest.mark.parametrize("name", ["median", "median9", "pil_emboss", RANK_NAME, KERNEL_NAME])
def test_lut_registry_refuses_rank_and_kernel_names_as_hipe_tpu_does(name):
    lut = np.arange(256)
    assert _error(tblur.register_lut_filter, name, lut) == _error(
        jblur.register_lut_filter, name, lut)


def test_registration_is_idempotent_in_both_packages():
    for mod in (jblur, tblur):
        rank_op, kernel_op = mod.FILTERS[RANK_NAME], mod.FILTERS[KERNEL_NAME]
        mod.register_rank_filter(RANK_NAME, 5, 6)
        mod.register_kernel_filter(KERNEL_NAME, list(KERNEL_TAPS), 7, 2.5)
        mod.register_kernel_filter("pil_emboss", *jblur.PIL_PRESETS["pil_emboss"])
        mod.register_rank_filter("median9", 9, 40)
        assert mod.FILTERS[RANK_NAME] is rank_op
        assert mod.FILTERS[KERNEL_NAME] is kernel_op
        assert mod.FILTER_RADIUS[RANK_NAME] == mod.FILTER_RADIUS[KERNEL_NAME] == 2


def test_k3_program_and_tap_table_encoding():
    names = ("median", KERNEL_NAME, "posterize4", RANK_NAME, "pil_emboss", "erode",
             KERNEL_NAME, "gaussian9", "dilate", "median9", LUT_NAME, "edge", LUT_NAME)
    program, tables, taps = chain_program.encode_program(names)
    # Triples (op, arg, size); op codes are enum Op of csrc/chain_stages.cuh.
    assert program == [7, 0, 0, 11, 0, 5, 5, 0xF0, 0, 10, 6, 5, 11, 27, 3, 8, 0, 0,
                       11, 0, 5, 0, 4, 0, 9, 0, 0, 10, 40, 9, 6, 0, 0, 2, 0, 0,
                       6, 0, 0]
    # Each kernel's [scale, off2, taps with the rows flipped], once.
    assert taps == [7, 5, *range(8, 13), *range(3, 8), *range(-2, 3), *range(-7, -2),
                    *range(-12, -7),
                    1, 256, 0, 0, 0, 0, 1, 0, -1, 0, 0]
    assert len(tables) == 1
    np.testing.assert_array_equal(tables[0], jblur.brightness_lut(0.7))


@pytest.mark.parametrize("names", [
    ("gaussian3", "sharpen", "edge"), ("gaussian9",), ("invert", LUT_NAME, "posterize2"),
    ("median",), ("gaussian3", "median"), ("erode", "dilate"), ("pil_emboss",),
    (LUT_NAME, KERNEL_NAME), (RANK_NAME,), ("solarize", "median9"),
], ids="+".join)
def test_routing_follows_hipe_tpu_mxu_rule(names, monkeypatch):
    # hipe_tpu's mxu_ok (pallas_blur.py:975) without its H % 8 clause.
    mxu_ok = all(nm.startswith("gaussian") or nm in ("sharpen", "edge")
                 or nm in jblur.POINT_STAGES for nm in names)
    assert chain_program.is_band_chain(names) == mxu_ok
    calls = []

    def spy(x, names, **kw):
        calls.append(names)
        return rank_chain_planar_cuda(x, names, **kw)

    monkeypatch.setattr(planar, "rank_chain_planar_cuda", spy)
    x = torch.from_numpy(_planes((2, 24, 17), seed=9))
    got = planar.filter_planar(x, names)
    assert calls == ([] if mxu_ok else [names])
    assert torch.equal(got, tblur.filter_chain(x, names, h_axis=-2, w_axis=-1))


def test_wrapper_on_cpu_launches_nothing_and_rejects_bad_calls():
    x = torch.from_numpy(_planes((2, 12, 9), seed=50))
    names = ("median", "gaussian3")
    want = tblur.filter_chain(x, names, h_axis=-2, w_axis=-1)
    out = torch.empty_like(x)
    assert rank_chain_planar_cuda(x, names, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert torch.equal(rank_chain_planar_cuda(x, names, h_pad=False), want[:, 2:-2])
    with pytest.raises(ValueError, match="band and point"):
        filter_chain_planar_cuda(x, names)
    assert rank_chain_planar_cuda.launches == 0
    assert filter_chain_planar_cuda.launches == 0
    with pytest.raises(KeyError, match="unknown filter stage"):
        rank_chain_planar_cuda(x, ("median", "mode"))
    with pytest.raises(ValueError, match="valid mode"):
        rank_chain_planar_cuda(x, ("median9", "median5"), h_pad=False)
    with pytest.raises(ValueError, match="shares memory"):
        rank_chain_planar_cuda(x, ("median",), out=x)
    with pytest.raises(ValueError, match="rows_per_block"):
        rank_chain_planar_cuda(x, ("median",), rows_per_block=0)
    with pytest.raises(TypeError):
        rank_chain_planar_cuda(x.int(), ("median",))
    assert rank_chain_planar_cuda.launches == 0


@pytest.fixture(scope="module", params=["denoise", "close", "median5"])
def rank_runners(request):
    image = jax_checker_image(32, 40, 3)
    jr = JaxRunner(request.param, num_images=4, image=image, use_pallas=False)
    tr = DeviceStreamRunner(request.param, num_images=4, image=image, device="cpu",
                            stream=np.asarray(jr.stream))
    return jr, tr


@pytest.mark.parametrize("r", [1, 3])
def test_rank_stream_passes_match_jax_runner(rank_runners, r):
    jr, tr = rank_runners
    want_stream = np.asarray(jax.lax.fori_loop(
        0, r, lambda i, x: jr._one_pass(x), jr.stream))
    got_sum = tr.chained(r)
    np.testing.assert_array_equal(tr.run_passes(r).numpy(), want_stream)
    assert got_sum == jr._sync(jr._chained(jr.stream, r))
    np.testing.assert_array_equal(tr.stream.numpy(), np.asarray(jr.stream))


def test_rank_stream_verify_max_abs_err_is_zero(rank_runners):
    jr, tr = rank_runners
    assert tr.pipeline.filters == jr.pipeline.filters
    assert tr.verify_max_abs_err() == 0
