"""The port's plain blur against hipe_tpu's kernels, XLA ops and NumPy oracle.

Every comparison is exact (max-abs 0): uint8 in, integer arithmetic, uint8
out, as everywhere in the repo. The Pallas kernels run in interpret mode on
the CPU, as hipe_tpu's own tests run them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hipe_tpu.ops import blur as jblur
from hipe_tpu.ops import pallas_blur
from hipe_tpu.ops import reference as jref
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import reference as tref
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_planar_cuda

SHAPES = [(6, 32, 40), (4, 37, 53)]
RADII = [1, 2, 3, 4]
# One compile per case instead of one per op: the eager XLA blur costs ~1.5 s.
_xla_blur_planar = jax.jit(jblur.gaussian_blur_planar, static_argnums=1,
                           static_argnames="h_pad")


def _planes(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _port(x, radius, h_pad):
    return tblur.gaussian_blur_planar(torch.from_numpy(x), radius, h_pad=h_pad).numpy()


def _oracle(x, radius, h_pad):
    """Per-plane oracle; valid mode keeps the rows whose taps need no clamp."""
    out = np.stack([tref.gaussian_blur_int_oracle(p, radius) for p in x])
    return out if h_pad else out[:, radius:x.shape[1] - radius]


@pytest.mark.parametrize("radius", RADII)
def test_binomial_taps_and_oracle_match_hipe_tpu(radius):
    t_taps, t_shift = tref.binomial_taps(radius)
    j_taps, j_shift = jref.binomial_taps(radius)
    np.testing.assert_array_equal(t_taps, j_taps)
    assert t_shift == j_shift == 2 * radius
    assert tblur.binomial_taps(radius) == jblur.binomial_taps(radius)
    img = np.random.default_rng(radius).integers(0, 256, (23, 31, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tref.gaussian_blur_int_oracle(img, radius),
                                  jref.gaussian_blur_int_oracle(img, radius))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", RADII)
def test_plain_blur_matches_xla_and_oracle(radius, h_pad, shape):
    x = _planes(shape, seed=radius)
    got = _port(x, radius, h_pad)
    want_xla = np.asarray(_xla_blur_planar(jnp.asarray(x), radius, h_pad=h_pad))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, _oracle(x, radius, h_pad))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("path", ["mxu", "vpu"])
def test_plain_blur_matches_pallas_blur(path, radius, h_pad, shape):
    x = _planes(shape, seed=10 + radius)
    want = np.asarray(pallas_blur.gaussian_blur_planar_pallas(
        jnp.asarray(x), radius, h_pad=h_pad, path=path, interpret=True))
    np.testing.assert_array_equal(_port(x, radius, h_pad), want)


# The int8-band chain kernel takes only H % 8 == 0 (hipe_tpu's routing rule).
@pytest.mark.parametrize("shape", [(6, 32, 40), (4, 40, 53)])
@pytest.mark.parametrize("h_pad", [True, False])
def test_plain_blur_matches_int8_chain_gaussian_stage(h_pad, shape):
    x = _planes(shape, seed=20)
    want = np.asarray(pallas_blur.filter_chain_planar_pallas(
        jnp.asarray(x), ("gaussian3",), h_pad=h_pad, int8_bands=True, interpret=True))
    np.testing.assert_array_equal(_port(x, 1, h_pad), want)


@pytest.mark.parametrize("h_pad", [True, False])
def test_wrapper_on_cpu_runs_plain_and_launches_nothing(h_pad):
    x = torch.from_numpy(_planes((4, 37, 53), seed=30))
    got = gaussian_blur_planar_cuda(x, 2, h_pad=h_pad, rows_per_block=8)
    np.testing.assert_array_equal(got.numpy(), _port(x.numpy(), 2, h_pad))
    out = torch.empty_like(got)
    assert gaussian_blur_planar_cuda(x, 2, h_pad=h_pad, out=out) is out
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    assert gaussian_blur_planar_cuda.launches == 0


def test_wrapper_rejects_bad_arguments():
    x = torch.from_numpy(_planes((2, 8, 5)))
    with pytest.raises(ValueError, match="radius"):
        gaussian_blur_planar_cuda(x, 5)
    with pytest.raises(ValueError, match="valid mode"):
        gaussian_blur_planar_cuda(x, 4, h_pad=False)
    with pytest.raises(TypeError):
        gaussian_blur_planar_cuda(x.int(), 1)
    with pytest.raises(ValueError, match="out"):
        gaussian_blur_planar_cuda(x, 1, out=torch.empty((2, 8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shares memory"):
        gaussian_blur_planar_cuda(x, 1, out=x)
