"""The port's scaled and grayscale decode on the CPU, held exactly against
hipe_tpu and libjpeg.

Mirrors ``test_jpeg_scaled.py``: every sampling layout at 1/2, 1/4 and 1/8
through ``decode_planes_scaled`` (the reduced IDCTs of jidctred.c as torch
ops, K6's plain version where a component's scaled size stays 8), against
``hipe_tpu``'s ``decode_planes_scaled`` on the JAX CPU backend and the
installed libjpeg's own scaled decode; ``scaled_sizes`` against the
library's probe; the host wrappers against ``hipe_tpu``'s. Inputs come from
numpy seeds; every comparison is exact (max-abs 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.io_ import jpeg as hjpeg
from hipe_tpu.ops import jpeg_decode as hjd
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.ops import jpeg_decode as tjd

SUBSAMPLINGS = ["420", "422", "444", "440", "411", "410", "311", "asym"]


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _exact(data: bytes, denom: int, batch: int = 2):
    """The port's scaled decode of ``data`` (a batch of ``batch`` copies)
    equals hipe_tpu's and libjpeg's."""
    co = tjpeg.read_coefficients(data)
    geo = tjd.geometry_of(co)
    qts = [c.qtable for c in co.components]
    coefs = [np.stack([c.coefs] * batch) for c in co.components]
    got = tjd.decode_planes_scaled(geo, [torch.from_numpy(c) for c in coefs], qts, denom)
    want = np.asarray(hjd.decode_planes_scaled(hjd.DecodeGeometry(*geo),
                                               [jnp.asarray(c) for c in coefs], qts, denom))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[-1].numpy(), hjpeg.decode_bytes_scaled(data, 1, denom))
    rows = tjd.decode_planes_scaled(geo, [torch.from_numpy(c) for c in coefs], qts, denom,
                                    layout="rows")
    np.testing.assert_array_equal(rows.numpy().reshape(got.shape), got.numpy())


def test_scaled_sizes_match_library_probe():
    img = _img(97, 123)
    for subs in ("420", "422", "444", "440", "411", "asym"):
        data = hjpeg.encode_bytes_opts(img, quality=85, subsampling=subs)
        geo = tjd.geometry_of(tjpeg.read_coefficients(data))
        for den in (1, 2, 4, 8):
            assert tjpeg.scaled_info(data, 1, den) == hjpeg.scaled_info(data, 1, den)
            (ow, oh), comps = tjpeg.scaled_info(data, 1, den)
            assert (ow, oh) == (-(-geo.width // den), -(-geo.height // den))
            sizes = tjd.scaled_sizes(geo, den)
            assert sizes == tuple(c[0] for c in comps) == \
                hjd.scaled_sizes(hjd.DecodeGeometry(*geo), den), (subs, den)
            for ci, (_, dw, dh) in enumerate(comps):
                assert tjd._scaled_down_dims(geo, ci, sizes[ci]) == (dh, dw)


@pytest.mark.parametrize("subs", SUBSAMPLINGS)
@pytest.mark.parametrize("denom", [2, 4, 8])
def test_scaled_decode_bit_exact(subs, denom):
    # Odd dims: MCU padding, ceil'd output dims, edge columns at scale.
    _exact(hjpeg.encode_bytes_opts(_img(33, 41, seed=denom), quality=85, subsampling=subs),
           denom)


def test_scaled_decode_narrow_chroma_replicates():
    # jdsample.c's downsampled_width > 2 guard acts on the scaled chroma
    # width: 4:2:2 at width 16 has chroma width 8 at full size but 2 at 1/4.
    for subs, w in (("422", 16), ("420", 12)):
        data = hjpeg.encode_bytes_opts(_img(24, w, seed=15), quality=85, subsampling=subs)
        for den in (2, 4):
            _exact(data, den)


def test_scaled_decode_even_dims_and_quality():
    for q in (5, 60, 95):
        data = hjpeg.encode_bytes_opts(_img(64, 64, seed=q), quality=q, subsampling="420")
        for den in (2, 4, 8):
            _exact(data, den)


def test_scaled_decode_grayscale():
    data = hjpeg.encode_bytes(_img(49, 57, 1, seed=7), quality=90)
    for den in (2, 4, 8):
        _exact(data, den)


def test_scaled_decode_progressive():
    data = hjpeg.encode_bytes_opts(_img(40, 48, seed=9), quality=85, subsampling="420",
                                   progressive=True)
    for den in (2, 4, 8):
        _exact(data, den)


def test_scaled_batch_leading_dims():
    datas = [hjpeg.encode_bytes_opts(_img(32, 40, seed=10 + i), quality=85, subsampling="420")
             for i in range(4)]
    cos = [tjpeg.read_coefficients(d) for d in datas]
    geo = tjd.geometry_of(cos[0])
    qts = [c.qtable for c in cos[0].components]
    nested = [torch.from_numpy(np.stack([co.components[ci].coefs for co in cos]).reshape(
        2, 2, *cos[0].components[ci].coefs.shape)) for ci in range(3)]
    out = tjd.decode_planes_scaled(geo, nested, qts, 2)
    assert out.shape == (2, 2, 16, 20, 3)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i // 2, i % 2].numpy(),
                                      hjpeg.decode_bytes_scaled(d, 1, 2))
        np.testing.assert_array_equal(
            tjd.decode_coefficients_scaled(cos[i], 2, device="cpu").numpy(),
            hjpeg.decode_bytes_scaled(d, 1, 2))


def test_scale_denom_1_is_full_decode():
    data = hjpeg.encode_bytes_opts(_img(24, 24, seed=11), quality=85, subsampling="420")
    co = tjpeg.read_coefficients(data)
    np.testing.assert_array_equal(tjd.decode_coefficients_scaled(co, 1, device="cpu").numpy(),
                                  hjpeg.decode_bytes(data))


@pytest.mark.parametrize("ssize", [1, 2, 4, 8])
@pytest.mark.parametrize("full_range", [True, False])
def test_reduced_idcts_match_hipe_tpu(ssize, full_range):
    """The reduced IDCT of dequantized blocks, int32 wrap-around included."""
    rng = np.random.default_rng(ssize * 2 + full_range)
    lo, hi = (-32768, 32768) if full_range else (-1024, 1024)
    coefs = rng.integers(lo, hi, (3, 5, 64)).astype(np.int16)
    q = rng.integers(1, 65536 if full_range else 256, 64).astype(np.uint16)
    blocks = tjd._dequant_planes(torch.from_numpy(coefs), q)
    got = tjd._idct_planes_reduced(blocks, ssize).numpy()
    planes = hjd._dequant_planes(jnp.asarray(coefs), q)
    out = hjd._idct_planes_reduced(planes, ssize)
    want = np.stack([np.stack([np.asarray(out[r * 8 + c]) for c in range(ssize)], axis=-1)
                     for r in range(ssize)], axis=-2).reshape(3, 5, ssize, ssize)
    np.testing.assert_array_equal(got, want)


def test_supported_scaled_gating_matches_hipe_tpu():
    data = hjpeg.encode_bytes_opts(_img(32, 32, seed=12), quality=85, subsampling="420")
    geo = tjd.geometry_of(tjpeg.read_coefficients(data))
    data411 = hjpeg.encode_bytes_opts(_img(32, 32, seed=12), quality=85, subsampling="411")
    geo411 = tjd.geometry_of(tjpeg.read_coefficients(data411))
    geo_suby = geo._replace(comps=((1, 1, geo.comps[0][2], geo.comps[0][3]),
                                   (2, 2, geo.comps[1][2], geo.comps[1][3]),
                                   (2, 2, geo.comps[2][2], geo.comps[2][3])), max_h=2, max_v=2)
    cases = [(geo, 2, True), (geo, 3, False), (geo, 16, False), (geo411, 2, True),
             (geo411, 8, True), (geo_suby, 2, False)]
    for g, den, want in cases:
        assert tjd.supported_scaled(g, den) is want
        assert hjd.supported_scaled(hjd.DecodeGeometry(*g), den) is want
    with pytest.raises(ValueError, match="unsupported sampling geometry"):
        tjd.decode_planes_scaled(geo_suby, [torch.zeros((2, 2, 64), dtype=torch.int16)] * 3,
                                 [np.ones(64)] * 3, 2)


@pytest.mark.parametrize("subs", ["420", "422", "444", "440"])
@pytest.mark.parametrize("denom", [1, 2, 4, 8])
def test_gray_geometry_decodes_libjpegs_grayscale(subs, denom):
    """``gray_geometry``: the luma alone decodes as libjpeg's JCS_GRAYSCALE
    output does, full size and scaled, and as hipe_tpu's gray view."""
    data = hjpeg.encode_bytes_opts(_img(35, 43, seed=denom), quality=80, subsampling=subs)
    co = tjpeg.read_coefficients(data)
    geo = tjd.gray_geometry(tjd.geometry_of(co))
    assert tuple(geo) == tuple(hjd.gray_geometry(hjd.geometry_of(co)))
    luma = co.components[0]
    got = tjd.decode_planes_scaled(geo, [torch.from_numpy(luma.coefs)], [luma.qtable], denom)
    want = np.asarray(hjd.decode_planes_scaled(hjd.DecodeGeometry(*geo),
                                               [jnp.asarray(luma.coefs)], [luma.qtable],
                                               denom))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  hjpeg.decode_bytes_scaled(data, 1, denom, force_gray=True))


def test_gray_geometry_needs_full_resolution_luma():
    geo = tjd.DecodeGeometry(16, 16, 3, ((1, 1, 1, 1), (2, 2, 2, 2), (2, 2, 2, 2)), 2, 2)
    with pytest.raises(ValueError, match="full-resolution luma"):
        tjd.gray_geometry(geo)


def test_host_scaled_api_matches_hipe_tpu():
    img = _img(50, 70, seed=13)
    data = hjpeg.encode_bytes(img, quality=90)
    np.testing.assert_array_equal(tjpeg.decode_bytes_scaled(data, 8, 8),
                                  tjpeg.decode_bytes(data))
    assert tjpeg.scaled_dims(data, 1, 4) == hjpeg.scaled_dims(data, 1, 4) == (13, 18, 3)
    assert tjpeg.decode_bytes_scaled(data, 2, 1).shape == (100, 140, 3)
    for den in (2, 4, 8):
        for gray in (False, True):
            np.testing.assert_array_equal(
                tjpeg.decode_bytes_scaled(data, 1, den, force_gray=gray),
                hjpeg.decode_bytes_scaled(data, 1, den, force_gray=gray))
    np.testing.assert_array_equal(tjpeg.decode_bytes(data, force_gray=True),
                                  hjpeg.decode_bytes(data, force_gray=True))
    payloads = [hjpeg.encode_bytes(_img(33, 41, seed=s), 85) for s in range(4)]
    for gray in (False, True):
        got = tjpeg.decode_batch_scaled(payloads, 1, 4, num_threads=2, force_gray=gray)
        np.testing.assert_array_equal(got, np.stack([
            hjpeg.decode_bytes_scaled(p, 1, 4, force_gray=gray) for p in payloads]))
        np.testing.assert_array_equal(tjpeg.decode_batch(payloads, force_gray=gray),
                                      hjpeg.decode_batch(payloads, force_gray=gray))
    with pytest.raises(ValueError, match="empty"):
        tjpeg.decode_batch_scaled([], 1, 2)
    with pytest.raises(ValueError, match="header"):
        tjpeg.scaled_dims(b"\xff\xd8 not a jpeg", 1, 2)
