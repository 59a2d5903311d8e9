"""The port's interleaved-rows layout against hipe_tpu's, exactly.

Rows are ``(B, H, W*C)`` uint8: each image row one vector of interleaved
channels, the W edge clamped a whole pixel (C lanes) at a time. Every
comparison is exact (max-abs 0). hipe_tpu's rows Pallas kernels run in
interpret mode on the CPU, as its own tests run them; the port's rows
wrappers run their plain versions on CPU tensors.

The registries are process-global in both packages, so every stage
registered here carries a ``torchport_`` name no other test file uses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.models import pipelines as jplib
from hipe_tpu.ops import blur as jblur
from hipe_tpu.ops import pallas_blur
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import planar
from hipe_tpu_torch.ops.cuda_blur import gaussian_blur_nhwc_cuda, gaussian_blur_rows_cuda
from hipe_tpu_torch.ops.cuda_chain import filter_chain_rows_cuda

LUT_NAME = "torchport_rows_dim"
RANK_NAME = "torchport_rows_q"
KERNEL_NAME = "torchport_rows_tilt"
for _pkg in (jblur, tblur):
    _pkg.register_lut_filter(LUT_NAME, jblur.gamma_lut(2.2))
    _pkg.register_rank_filter(RANK_NAME, 5, 6)
    _pkg.register_kernel_filter(KERNEL_NAME, range(-12, 13), 7, 2.5)

BUILTIN_STAGES = sorted(n for n in jblur.ROWS_FILTERS if not n.startswith("torchport_"))
REGISTERED = [LUT_NAME, RANK_NAME, KERNEL_NAME]
BAND_CHAINS = [("gaussian3", "sharpen", "edge"), ("edge",), ("gaussian5", "solarize"),
               ("posterize4", "gaussian9", "edge"), (LUT_NAME, "sharpen")]
# The stencil pipelines; the global-statistics family has its own tests
# (tests/test_torch_global_stats.py).
PIPELINES = sorted(n for n, p in tplib.PIPELINES.items() if isinstance(p, tplib.Pipeline))


def _rows(b, h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w * c), dtype=np.uint8)


def test_every_rows_stage_is_ported():
    assert set(jblur.ROWS_FILTERS) <= set(tblur.ROWS_FILTERS)
    assert set(tblur.ROWS_FILTERS) == set(tblur.FILTERS)


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("name", BUILTIN_STAGES + REGISTERED)
def test_rows_stage_matches_hipe_tpu(name, h_pad):
    for c in (1, 3, 4):
        x = _rows(2, 13, 11, c, seed=c + len(name))
        got = tblur.ROWS_FILTERS[name](torch.from_numpy(x), c, h_pad=h_pad).numpy()
        want = np.asarray(jblur.ROWS_FILTERS[name](jnp.asarray(x), c, h_pad=h_pad))
        np.testing.assert_array_equal(got, want, err_msg=f"C={c}")


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_rows_chain_matches_hipe_tpu_and_planar(c, h_pad):
    names = ("median", "gaussian3", RANK_NAME, "edge")
    x = _rows(2, 24, 17, c, seed=c)
    got = tblur.filter_chain_rows(torch.from_numpy(x), c, names, h_pad=h_pad).numpy()
    want = np.asarray(jblur.filter_chain_rows(jnp.asarray(x), c, names, h_pad=h_pad))
    np.testing.assert_array_equal(got, want)
    # The same integers as the planar chain on the relaid-out planes.
    planes = torch.from_numpy(x.reshape(2, 24, 17, c).transpose(0, 3, 1, 2).copy())
    planar = tblur.filter_chain(planes, names, h_axis=-2, w_axis=-1, h_pad=h_pad).numpy()
    np.testing.assert_array_equal(got.reshape(2, -1, 17, c), planar.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_rows_blur_wrapper_matches_pallas_rows_kernel(radius, c, h_pad):
    x = _rows(2, 32, 40, c, seed=radius * 10 + c)
    got = gaussian_blur_rows_cuda(torch.from_numpy(x), c, radius, h_pad=h_pad).numpy()
    want = pallas_blur.gaussian_blur_rows_pallas(jnp.asarray(x), c, radius, h_pad=h_pad,
                                                 interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("names", BAND_CHAINS, ids="+".join)
def test_rows_chain_wrapper_matches_pallas_rows_kernel(names, c, h_pad):
    x = _rows(2, 32, 24, c, seed=len(names) * 10 + c)
    got = filter_chain_rows_cuda(torch.from_numpy(x), c, names, h_pad=h_pad).numpy()
    want = pallas_blur.filter_chain_rows_pallas(jnp.asarray(x), c, names, h_pad=h_pad,
                                                interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("name", PIPELINES)
def test_apply_rows_and_nhwc_match_hipe_tpu(name, h_pad):
    tpipe, jpipe = tplib.get(name), jplib.get(name)
    for c in (1, 3, 4):
        x = _rows(2, 21, 19, c, seed=c + len(name))
        got = tpipe.apply_rows(torch.from_numpy(x), c, h_pad=h_pad).numpy()
        if h_pad:
            want = np.asarray(jpipe.apply_rows(jnp.asarray(x), c, use_pallas=False))
        else:
            want = np.asarray(jblur.filter_chain_rows(jnp.asarray(x), c, jpipe.filters,
                                                      h_pad=False))
        np.testing.assert_array_equal(got, want, err_msg=f"C={c}")
        nhwc = x.reshape(2, 21, 19, c)
        got_nhwc = tpipe.apply_nhwc(torch.from_numpy(nhwc), h_pad=h_pad).numpy()
        np.testing.assert_array_equal(got_nhwc, want.reshape(2, -1, 19, c), err_msg=f"C={c}")
        if h_pad:
            np.testing.assert_array_equal(
                got_nhwc, np.asarray(jpipe.apply_nhwc(jnp.asarray(nhwc), use_pallas=False)))


def test_apply_rows_out_and_nhwc_blur_wrapper():
    x = torch.from_numpy(_rows(2, 16, 20, 3, seed=1))
    pipe = tplib.get("blur5")
    want = tblur.gaussian_blur_rows(x, 3, 2)
    out = torch.empty_like(x)
    assert pipe.apply_rows(x, 3, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    nhwc = x.view(2, 16, 20, 3)
    np.testing.assert_array_equal(gaussian_blur_nhwc_cuda(nhwc, 2).numpy(),
                                  want.view(2, 16, 20, 3).numpy())
    want_np = np.asarray(pallas_blur.gaussian_blur_nhwc_pallas(
        jnp.asarray(nhwc.numpy()), 2, interpret=True))
    np.testing.assert_array_equal(gaussian_blur_nhwc_cuda(nhwc, 2).numpy(), want_np)


def _kernels_of_rows(monkeypatch, pipe, h, w, **kw):
    """The wrappers ``pipe.apply_rows`` calls for (1, H, W*3) rows off the
    CPU (meta tensors: shapes only), by the names of their kernels."""
    seen = []

    def spy(kernel):
        def wrapper(x, *args, **kwargs):
            seen.append(kernel)
            return torch.empty_like(x)
        return wrapper

    monkeypatch.setattr(tplib, "gaussian_blur_rows_cuda", spy("K1 rows"))
    for kernel, name in (("K1", "gaussian_blur_planar_cuda"), ("K2", "filter_chain_planar_cuda"),
                         ("K3", "rank_chain_planar_cuda"),
                         ("K4/K5", "filter_chain_planar_tiled_cuda")):
        monkeypatch.setattr(planar, name, spy(kernel))
    pipe.apply_rows(torch.empty((1, h, w * 3), dtype=torch.uint8, device="meta"), 3, **kw)
    return seen


def test_rows_entry_fits_shared_memory(monkeypatch):
    blur3 = tplib.get("blur3")
    # K1's rows entry keeps its row sums in registers: the 5000-image
    # stream's rows, 256 x 768 lanes, take it at every band height, whole
    # planes too, and so do 4000-pixel RGB rows.
    for rpb in (None, 128, 256):
        assert _kernels_of_rows(monkeypatch, blur3, 256, 256, rows_per_block=rpb) == ["K1 rows"]
    assert _kernels_of_rows(monkeypatch, blur3, 2250, 4000) == ["K1 rows"]
    # Only a single gaussian has a rows entry on the card's route; a chain
    # relayouts to planar, where the route sends it to K2 or K3.
    assert _kernels_of_rows(monkeypatch, tplib.get("chain"), 32, 32) == ["K2"]
    assert _kernels_of_rows(monkeypatch, tplib.get("denoise"), 32, 32) == ["K3"]


def test_rows_wrappers_on_cpu_launch_nothing_and_check_their_arguments():
    x = torch.from_numpy(_rows(2, 12, 9, 3, seed=5))
    gaussian_blur_rows_cuda(x, 3, 1)
    filter_chain_rows_cuda(x, 3, ("gaussian3", "edge"))
    tplib.get("denoise").apply_rows(x, 3)
    assert gaussian_blur_rows_cuda.launches == filter_chain_rows_cuda.launches == 0
    with pytest.raises(ValueError, match="multiple of"):
        gaussian_blur_rows_cuda(x, 4, 1)
    with pytest.raises(ValueError, match="multiple of"):
        tplib.get("blur3").apply_rows(x, 5)
    with pytest.raises(ValueError, match="shares memory"):
        gaussian_blur_rows_cuda(x, 3, 1, out=x)
    with pytest.raises(ValueError, match="valid mode"):
        gaussian_blur_rows_cuda(x[:, :8].contiguous(), 3, 4, h_pad=False)
    with pytest.raises(ValueError, match="band and point"):
        filter_chain_rows_cuda(x, 3, ("median", "gaussian3"))
    with pytest.raises(TypeError):
        filter_chain_rows_cuda(x.int(), 3, ("edge",))
