"""The port's large-frame path against hipe_tpu's halo-tiled kernels, exactly.

hipe_tpu's ``gaussian_blur_planar_tiled_pallas`` and
``filter_chain_planar_tiled_pallas`` (kernels (e) and (f)) run in interpret
mode on the CPU, as its own tests run them, against the port's tiled
wrappers (K4, K5) on CPU tensors, which run their plain versions. Also the
shared-memory routing rule, the tiled route of ``Pipeline.apply_planar``
and ``DeviceStreamRunner`` on frames that take it.

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
from hipe_tpu.runtime.device_stream import DeviceStreamRunner as JaxRunner
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import cuda_tiled, planar
from hipe_tpu_torch.ops.cuda_tiled import (filter_chain_planar_tiled_cuda,
                                           filter_stage_planar_tiled_cuda,
                                           gaussian_blur_planar_tiled_cuda)
from hipe_tpu_torch.runtime.device_stream import DeviceStreamRunner

LUT_NAME = "torchport_tiled_dim"
RANK_NAME = "torchport_tiled_q"
KERNEL_NAME = "torchport_tiled_tilt"
for _pkg in (jblur, tblur):
    _pkg.register_lut_filter(LUT_NAME, jblur.brightness_lut(0.7))
    _pkg.register_rank_filter(RANK_NAME, 5, 6)
    _pkg.register_kernel_filter(KERNEL_NAME, range(-12, 13), 7, 2.5)

# Ragged heights, each with the tile height hipe_tpu runs it at.
GEOMETRIES = [(47, 8), (100, 16), (130, 32)]
STAGES = ["sharpen", "edge", "invert", "solarize", "posterize4", LUT_NAME, "median",
          "erode", "dilate", "median5", RANK_NAME, "median7", "median9", "pil_emboss",
          "pil_smooth_more", KERNEL_NAME]


def _planes(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


@pytest.mark.parametrize("h,tile_h", GEOMETRIES)
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_k4_wrapper_matches_tiled_pallas_blur(radius, h, tile_h):
    x = _planes(2, h, 40, seed=radius + h)
    want = np.asarray(pallas_blur.gaussian_blur_planar_tiled_pallas(
        jnp.asarray(x), radius, tile_h=tile_h, interpret=True))
    for tile in ((tile_h, 16), (5, 7)):
        got = gaussian_blur_planar_tiled_cuda(torch.from_numpy(x), radius, tile=tile)
        np.testing.assert_array_equal(got.numpy(), want)
    valid = gaussian_blur_planar_tiled_cuda(torch.from_numpy(x), radius, h_pad=False)
    np.testing.assert_array_equal(
        valid.numpy(), np.asarray(jblur.gaussian_blur_planar(jnp.asarray(x), radius,
                                                             h_pad=False)))


@pytest.mark.parametrize("h,tile_h", GEOMETRIES)
@pytest.mark.parametrize("name", STAGES)
def test_k5_wrapper_matches_tiled_pallas_stage(name, h, tile_h):
    x = _planes(1, h, 40, seed=len(name) + h)
    want = np.asarray(pallas_blur.filter_chain_planar_tiled_pallas(
        jnp.asarray(x), (name,), tile_h=tile_h, interpret=True))
    got = filter_stage_planar_tiled_cuda(torch.from_numpy(x), name, tile=(tile_h, 16))
    np.testing.assert_array_equal(got.numpy(), want)
    valid = filter_stage_planar_tiled_cuda(torch.from_numpy(x), name, h_pad=False)
    want_valid = jblur.filter_chain(jnp.asarray(x), (name,), h_axis=-2, w_axis=-1,
                                    h_pad=False)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("names", [("gaussian3", "sharpen", "edge"), ("median", "gaussian3"),
                                   ("gaussian9", "median9", LUT_NAME),
                                   (KERNEL_NAME, "gaussian5", RANK_NAME)], ids="+".join)
def test_tiled_chain_matches_hipe_tpu(names, h_pad):
    x = _planes(2, 130, 40, seed=len(names))
    got = filter_chain_planar_tiled_cuda(torch.from_numpy(x), names, h_pad=h_pad).numpy()
    want_xla = jblur.filter_chain(jnp.asarray(x), names, h_axis=-2, w_axis=-1, h_pad=h_pad)
    np.testing.assert_array_equal(got, np.asarray(want_xla))
    if h_pad:  # hipe_tpu's tiled chain has no valid mode (it sends that to XLA)
        want = pallas_blur.filter_chain_planar_tiled_pallas(jnp.asarray(x), names,
                                                            tile_h=32, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_routes_tiled_follows_shared_memory():
    assert planar.SHARED_BYTES_PER_BLOCK == 227 * 1024
    for name in ("blur3", "chain", "denoise"):
        pipe = tplib.get(name)
        # The reference's 4000x2250 frame: K2's and K3's 32-row tile needs
        # 2 * 38 * 4032 B = 306 KB; K1 takes no shared memory, so blur3
        # stays on it at any width.
        assert pipe.routes_tiled(2250, 4000) == (name != "blur3")
        assert not pipe.routes_tiled(256, 256)
        assert not pipe.routes_tiled(1080, 1920)
    assert planar.fused_shared_bytes(32, 4000, ("gaussian3",)) == 0
    # K2's padded rows: 4000 + 20 bytes, rounded up to 16.
    assert planar.fused_shared_bytes(32, 4000, ("gaussian3", "sharpen", "edge")) == 2 * 38 * 4032
    # The widest plane each kernel's 32-row tile still fits: K1 has none.
    assert not planar.routes_tiled(32, 3419, ("gaussian3",))
    assert not planar.routes_tiled(32, 1 << 20, ("gaussian3",))
    assert not planar.routes_tiled(32, 3032, ("gaussian3", "sharpen", "edge"))
    assert planar.routes_tiled(32, 3033, ("gaussian3", "sharpen", "edge"))
    # A plane shorter than the tile is judged at its own height.
    assert not planar.routes_tiled(4, 9000, ("edge",))


def test_oversized_chain_routes_to_tiled_kernels(monkeypatch):
    """apply_planar on planes too wide for K2 takes the tiled route, both
    modes, with hipe_tpu's integers."""
    calls = []
    real = planar.filter_chain_planar_tiled_cuda
    monkeypatch.setattr(planar, "filter_chain_planar_tiled_cuda",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    x = _planes(1, 40, 3500, seed=9)
    pipe = tplib.PIPELINES["chain"]
    jpipe = jplib.PIPELINES["chain"]
    for h_pad in (True, False):
        got = pipe.apply_planar(torch.from_numpy(x), h_pad=h_pad).numpy()
        want = jpipe.apply_planar(jnp.asarray(x), use_pallas=False, h_pad=h_pad)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert [k["h_pad"] for k in calls] == [True, False]
    want_tiled = pallas_blur.filter_chain_planar_tiled_pallas(
        jnp.asarray(x), jpipe.filters, tile_h=8, interpret=True)
    np.testing.assert_array_equal(pipe.apply_planar(torch.from_numpy(x)).numpy(),
                                  np.asarray(want_tiled))
    # The 256x256 stream's planes stay on the fused kernels.
    pipe.apply_planar(torch.from_numpy(_planes(1, 256, 256, seed=1)))
    assert len(calls) == 3


def test_shared_bytes_and_tile_checks():
    # TH + 2r window rows of the tile's columns and 16 bytes on each side.
    assert planar.tiled_shared_bytes("gaussian3", (16, 512)) == 18 * 544
    assert planar.tiled_shared_bytes("median9", (16, 512)) == 24 * 544
    assert planar.tiled_shared_bytes("invert", None) == 32 * 288
    # A width that is no multiple of 16 takes 24 bytes of pads; TW is
    # rounded up to a run of 8 first.
    assert planar.tiled_shared_bytes("edge", (5, 7)) == 7 * 32
    assert planar.tiled_shared_bytes("edge", (5, 8)) == 7 * 32
    assert planar.tiled_shared_bytes("edge", (5, 9)) == 7 * 48
    # The full-width strip over the 4000-wide frames.
    assert planar.tiled_shared_bytes("gaussian3", (32, 4000)) == 34 * 4032
    with pytest.raises(ValueError, match="positive"):
        cuda_tiled.check_tile((0, 8))


def test_tiled_wrappers_on_cpu_launch_nothing_and_check_their_arguments():
    x = torch.from_numpy(_planes(2, 20, 30, seed=3))
    out = torch.empty_like(x)
    assert filter_chain_planar_tiled_cuda(x, ("gaussian3", "edge"), out=out) is out
    np.testing.assert_array_equal(
        out.numpy(), tblur.filter_chain(x, ("gaussian3", "edge"), h_axis=-2, w_axis=-1).numpy())
    gaussian_blur_planar_tiled_cuda(x, 2)
    filter_stage_planar_tiled_cuda(x, "median")
    assert gaussian_blur_planar_tiled_cuda.launches == 0
    assert filter_stage_planar_tiled_cuda.launches == 0
    with pytest.raises(ValueError, match="K4"):
        filter_stage_planar_tiled_cuda(x, "gaussian5")
    with pytest.raises(ValueError, match="shares memory"):
        filter_chain_planar_tiled_cuda(x, ("edge",), out=x)
    with pytest.raises(ValueError, match="valid mode"):
        filter_chain_planar_tiled_cuda(x, ("gaussian9",) * 3, h_pad=False)
    with pytest.raises(ValueError, match="radius"):
        gaussian_blur_planar_tiled_cuda(x, 5)
    with pytest.raises(KeyError, match="unknown"):
        filter_chain_planar_tiled_cuda(x, ("nope",))
    with pytest.raises(TypeError):
        filter_chain_planar_tiled_cuda(x.int(), ("edge",))


def test_runner_takes_the_tiled_route_on_wide_frames():
    image = np.random.default_rng(4).integers(0, 256, (40, 3500, 3), dtype=np.uint8)
    jr = JaxRunner("chain", num_images=2, image=image, use_pallas=False)
    tr = DeviceStreamRunner("chain", num_images=2, image=image, device="cpu",
                            stream=np.asarray(jr.stream))
    assert tr.pipeline.routes_tiled(40, 3500) and tr.config == {"tile": None}
    labels = [label for label, _, why in tr.candidates if why is None]
    assert labels == [f"cuda_tile{th}x{tw}" for th in (8, 16, 32, 64) for tw in (128, 256, 512)]
    import jax

    want = np.asarray(jax.lax.fori_loop(0, 2, lambda i, x: jr._one_pass(x), jr.stream))
    np.testing.assert_array_equal(tr.run_passes(2).numpy(), want)
    assert tr.verify_max_abs_err() == 0
    small = DeviceStreamRunner("chain", num_images=1, image=image[:, :64], device="cpu")
    assert not small.pipeline.routes_tiled(40, 64) and small.config == {"rows_per_block": None}
