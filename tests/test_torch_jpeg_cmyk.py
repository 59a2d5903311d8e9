"""4-component (Adobe CMYK and YCCK) streams in the port, on the CPU, held
exactly against hipe_tpu and libjpeg.

Mirrors ``test_jpeg_cmyk.py``: the host codec's CMYK encode and decode, the
device decode of both colour spaces (each component's IDCT on K6's plain
version, the per-component upsample, jdcolor.c's null and
ycck_cmyk_convert) at full size and at 1/2, 1/4 and 1/8, the batch reader's
colour space, a ``hipe_tpu`` ``JpegCoefficients`` carried over whole, and
serving's refusal. Every comparison is exact (max-abs 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.io_ import jpeg as hjpeg
from hipe_tpu.ops import jpeg_decode as hjd
from hipe_tpu.runtime.serve import ServingPipeline as JaxServingPipeline
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.ops import jpeg_decode as tjd
from hipe_tpu_torch.runtime.serve import ServingPipeline


def _rand4(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def _device_exact(data: bytes, denom: int = 1):
    """The port's decode of ``data`` equals hipe_tpu's and libjpeg's."""
    co = tjpeg.read_coefficients(data)
    got = tjd.decode_coefficients_scaled(co, denom, device="cpu").numpy()
    want = np.asarray(hjd.decode_planes_scaled(  # op by op: faster here than a jit
        hjd.DecodeGeometry(*tjd.geometry_of(co)), [jnp.asarray(c.coefs) for c in co.components],
        [c.qtable for c in co.components], denom))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hjpeg.decode_bytes_scaled(data, 1, denom))
    return co


@pytest.mark.parametrize("ycck", [False, True])
def test_host_roundtrip_and_classification(ycck):
    img = _rand4(32, 40, seed=1)
    data = tjpeg.encode_cmyk_bytes(img, quality=95, ycck=ycck)
    assert data == hjpeg.encode_cmyk_bytes(img, quality=95, ycck=ycck)
    out = tjpeg.decode_bytes(data)
    assert out.shape == (32, 40, 4)
    np.testing.assert_array_equal(out, hjpeg.decode_bytes(data))
    co = tjpeg.read_coefficients(data)
    assert co.color_space == (5 if ycck else 4)
    if ycck:
        assert [(c.h_samp, c.v_samp) for c in co.components] == \
            [(2, 2), (1, 1), (1, 1), (2, 2)]
    else:
        assert all((c.h_samp, c.v_samp) == (1, 1) for c in co.components)
    with pytest.raises(ValueError, match="no grayscale conversion"):
        tjpeg.decode_bytes(data, force_gray=True)
    with pytest.raises(ValueError, match="CMYK"):
        tjpeg.encode_cmyk_bytes(img[..., :3])


@pytest.mark.parametrize("ycck", [False, True])
@pytest.mark.parametrize("dims", [(33, 41), (32, 48)])
def test_device_decode_bit_exact(ycck, dims):
    h, w = dims
    co = _device_exact(tjpeg.encode_cmyk_bytes(_rand4(h, w, seed=h), quality=85, ycck=ycck))
    assert tjd.supported(tjd.geometry_of(co))


def test_device_decode_progressive():
    data = hjpeg.encode_cmyk_bytes(_rand4(40, 36, seed=3), quality=70, ycck=True,
                                   progressive=True)
    assert _device_exact(data).progressive


@pytest.mark.parametrize("ycck", [False, True])
@pytest.mark.parametrize("denom", [2, 4, 8])
def test_scaled_device_decode_bit_exact(ycck, denom):
    data = hjpeg.encode_cmyk_bytes(_rand4(33, 41, seed=denom), quality=85, ycck=ycck)
    co = _device_exact(data, denom)
    assert tjd.supported_scaled(tjd.geometry_of(co), denom)


def test_batch_reader_carries_color_space():
    datas = [hjpeg.encode_cmyk_bytes(_rand4(16, 24, seed=s), quality=80, ycck=bool(s % 2))
             for s in range(4)]
    cos = tjpeg.read_coefficients_batch(datas)
    assert [c.color_space for c in cos] == [4, 5, 4, 5]
    for co, data in zip(cos, datas):
        np.testing.assert_array_equal(tjd.decode_coefficients(co, device="cpu").numpy(),
                                      hjpeg.decode_bytes(data))


@pytest.mark.parametrize("ycck", [False, True])
def test_from_coefficients_carries_a_hipe_tpu_stream_whole(ycck):
    """One entropy decode (hipe_tpu's) feeds both decoders, batched."""
    data = hjpeg.encode_cmyk_bytes(_rand4(29, 35, seed=9), quality=75, ycck=ycck)
    ref = hjpeg.read_coefficients(data)
    co = tjpeg.JpegCoefficients.from_coefficients(ref)
    assert (co.width, co.height, co.max_h, co.max_v, co.progressive, co.color_space) == \
        (ref.width, ref.height, ref.max_h, ref.max_v, ref.progressive, ref.color_space)
    for a, b in zip(co.components, ref.components):
        assert (a.h_samp, a.v_samp) == (b.h_samp, b.v_samp)
        np.testing.assert_array_equal(a.coefs, b.coefs)
        np.testing.assert_array_equal(a.qtable, b.qtable)
    geo = tjd.geometry_of(co)
    assert tuple(geo) == tuple(hjd.geometry_of(ref))
    coefs = [np.stack([c.coefs] * 3) for c in co.components]
    qts = [c.qtable for c in co.components]
    got = tjd.decode_planes(geo, [torch.from_numpy(c) for c in coefs], qts, layout="rows")
    want = hjd.decode_planes(hjd.geometry_of(ref), [jnp.asarray(c) for c in coefs], qts,
                             layout="rows")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="color_space"):
        tjpeg.JpegCoefficients.from_arrays(8, 8, coefs, qts, [(1, 1)] * 4)


@pytest.mark.parametrize("color", [4, 5])
def test_cmyk_rows_match_hipe_tpu(color):
    comps = [np.random.default_rng(color * 10 + i).integers(0, 256, (2, 5, 7)).astype(np.int16)
             for i in range(4)]
    got = tjd._cmyk_rows([torch.from_numpy(c) for c in comps], color)
    want = hjd._cmyk_rows([jnp.asarray(c, jnp.int32) for c in comps], color)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unclassified_four_component_geometry_unsupported():
    geo = tjd.DecodeGeometry(width=16, height=16, ncomps=4, comps=((1, 1, 2, 2),) * 4,
                             max_h=1, max_v=1)
    assert not tjd.supported(geo) and not hjd.supported(hjd.DecodeGeometry(*geo))
    with pytest.raises(ValueError, match="unsupported"):
        tjd.decode_planes(geo, [torch.zeros((2, 2, 64), dtype=torch.int16)] * 4,
                          [np.ones(64)] * 4)


@pytest.mark.parametrize("dec,enc", [(False, False), (True, False), (False, True),
                                     (True, True)])
@pytest.mark.parametrize("opts", [{}, {"decode_scale": 2}, {"decode_gray": True}])
def test_serving_rejects_cmyk_payloads(dec, enc, opts):
    """4-component payloads go to the host decode, which refuses them, as
    hipe_tpu's does, even now that the device decoder takes them."""
    data = hjpeg.encode_cmyk_bytes(_rand4(24, 24, seed=9), quality=85)
    with pytest.raises(ValueError) as want:
        JaxServingPipeline("blur3", use_pallas=False, decode_on_device=dec,
                           encode_on_device=enc, **opts).process_batch([data])
    with ServingPipeline("blur3", device="cpu", decode_on_device=dec, encode_on_device=enc,
                         **opts) as sp:
        with pytest.raises(ValueError, match="CMYK") as got:
            sp.process_batch([data])
    assert ("grayscale" in str(got.value)) == ("grayscale" in str(want.value))
