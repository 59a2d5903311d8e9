"""K6's and K7's plain versions on the CPU, held exactly against hipe_tpu.

The port's plain IDCT (``jpeg_decode.idct8x8_islow``) and plain fDCT +
quantize (``jpeg_encode.fdct_quantize_plain``) are what kernels K6 and K7
are held against on the card. Here they are held against ``hipe_tpu``'s
Pallas DCT kernels in interpret mode and its XLA plane graphs, on the same
numpy inputs: full-range int16 coefficients (whose dequantized products
overflow int32 and wrap), 8- and 16-bit quant tables. Every case is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import jpeg_decode as hjd
from hipe_tpu.ops import jpeg_encode as hje
from hipe_tpu.ops import pallas_dct as hpd
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.ops import cuda_dct
from hipe_tpu_torch.ops import jpeg_decode as tjd
from hipe_tpu_torch.ops import jpeg_encode as tje

GRIDS = [(5, 7), (4, 16), (1, 1), (32, 32)]


def _table(rng) -> np.ndarray:
    """A (64,) uint16 quant table: half 8-bit entries, half 16-bit, 65535
    among them."""
    q = np.concatenate([rng.integers(1, 256, 32), rng.integers(256, 65536, 32)])
    q[3] = 65535
    return rng.permutation(q).astype(np.uint16)


def _coefs(rng, hb: int, wb: int) -> np.ndarray:
    """(2, hb, wb, 64) int16: image 0 over the full int16 range (+-32767 and
    -32768 among it), image 1 over [-2048, 2048)."""
    full = rng.integers(-32768, 32768, (hb, wb, 64))
    full.reshape(-1)[:4] = [32767, -32767, -32768, 32767]
    return np.stack([full, rng.integers(-2048, 2048, (hb, wb, 64))]).astype(np.int16)


@pytest.mark.parametrize("grid", GRIDS)
def test_plain_idct_matches_pallas_kernel_and_xla(grid):
    hb, wb = grid
    rng = np.random.default_rng(hb * 100 + wb)
    q = _table(rng)
    coefs = _coefs(rng, hb, wb)
    got = tjd.idct8x8_islow(torch.from_numpy(coefs), q).numpy()
    assert got.shape == (2, hb * 8, wb * 8) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(hjd.idct8x8_islow(jnp.asarray(coefs), q)))
    planes = hpd.dequant_idct_planes_pallas(jnp.asarray(coefs), q, interpret=True, block_b=2)
    pallas = np.asarray(hjd._grid_from_planes(planes, hb, wb, range(8), range(8)))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("grid", GRIDS)
def test_plain_fdct_quantize_matches_pallas_kernel_and_xla(grid):
    hb, wb = grid
    rng = np.random.default_rng(hb * 100 + wb)
    q = _table(rng)
    img = rng.integers(0, 256, (3, hb * 8, wb * 8)).astype(np.uint8)
    got = tje.fdct_quantize_plain(torch.from_numpy(img), q).numpy()
    assert got.shape == (3, hb, wb, 64) and got.dtype == np.int16
    xla = hje.fdct_quantize(jnp.asarray(img, jnp.int32), q)
    np.testing.assert_array_equal(got, np.asarray(xla))
    pallas = hje.fdct_quantize(jnp.asarray(img, jnp.int32), q, pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("quality", [1, 50, 75, 90, 100])
def test_plain_fdct_quantize_matches_xla_on_quality_tables(quality):
    rng = np.random.default_rng(quality)
    img = rng.integers(0, 256, (2, 32, 128)).astype(np.uint8)
    for q in tjpeg.quality_tables(quality):
        got = tje.fdct_quantize_plain(torch.from_numpy(img), q).numpy()
        want = hje.fdct_quantize(jnp.asarray(img, jnp.int32), q)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_range_limit_over_every_residue():
    table = np.zeros(1024, dtype=np.int32)
    table[0:128] = np.arange(128) + 128
    table[128:512] = 255
    table[512:896] = 0
    table[896:1024] = np.arange(128)
    vals = np.concatenate([np.arange(-4096, 4096), [2**31 - 1, -2**31, 2**20 + 5, -2**25]])
    vals = vals.astype(np.int32)
    got = tjd._range_limit(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, table[vals & 1023])
    np.testing.assert_array_equal(got, np.asarray(hjd._range_limit(jnp.asarray(vals))))


def test_descale_and_1d_passes_wrap_as_hipe_tpu():
    rng = np.random.default_rng(5)
    d = [rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32) for _ in range(8)]
    td = [torch.from_numpy(x) for x in d]
    jdd = [jnp.asarray(x) for x in d]
    for final in (False, True):
        for got, want in zip(tjd._idct_1d(td, final), hjd._idct_1d(jdd, final)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tje._fdct_1d(td, final), hje._fdct_1d(jdd, final)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n in (2, 11, 15, 18):
        np.testing.assert_array_equal(tjd._descale(td[0], n).numpy(),
                                      np.asarray(hjd._descale(jdd[0], n)))


def test_grid_and_block_relayouts_are_inverse():
    x = torch.arange(2 * 24 * 40, dtype=torch.int32).reshape(2, 24, 40)
    blocks = tje._planes_from_grid(x)
    assert blocks.shape == (2, 3, 5, 8, 8)
    assert torch.equal(blocks[1, 2, 4], x[1, 16:24, 32:40])
    assert torch.equal(tjd._grid_from_planes(blocks), x)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(6)
    q = _table(rng)
    coefs = torch.from_numpy(_coefs(rng, 2, 5))
    before = cuda_dct.dequant_idct_cuda.launches
    out = torch.empty((2, 16, 40), dtype=torch.uint8)
    got = cuda_dct.dequant_idct_cuda(coefs, torch.from_numpy(q.astype(np.int32)), out=out)
    assert got is out and torch.equal(got, tjd.idct8x8_islow(coefs, q))
    grid = torch.from_numpy(rng.integers(0, 256, (3, 16, 40)).astype(np.uint8))
    got = cuda_dct.fdct_quantize_cuda(grid, q)
    assert torch.equal(got, tje.fdct_quantize_plain(grid, q))
    # The CPU path launches nothing.
    assert cuda_dct.dequant_idct_cuda.launches == before


@pytest.mark.parametrize("q,msg", [
    (np.ones(63), "(64,)"),
    (np.ones((8, 8)), "(64,)"),
    (np.zeros(64), "1..65535"),
    (np.full(64, 65536), "1..65535"),
])
def test_quant_tables_are_checked(q, msg):
    coefs = torch.zeros((1, 1, 1, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match=msg.replace("(", r"\(").replace(")", r"\)")):
        cuda_dct.dequant_idct_cuda(coefs, q)
    with pytest.raises(ValueError):
        cuda_dct.fdct_quantize_cuda(torch.zeros((1, 8, 8), dtype=torch.uint8), q)


def test_wrapper_inputs_are_checked():
    q = np.ones(64)
    with pytest.raises(TypeError, match="int16"):
        cuda_dct.dequant_idct_cuda(torch.zeros((1, 1, 1, 64), dtype=torch.int32), q)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_dct.dequant_idct_cuda(torch.zeros((1, 2, 3, 64), dtype=torch.int16)
                                   .transpose(1, 2), q)
    with pytest.raises(ValueError, match="end in 64"):
        cuda_dct.dequant_idct_cuda(torch.zeros((1, 1, 1, 63), dtype=torch.int16), q)
    with pytest.raises(TypeError, match="uint8"):
        cuda_dct.fdct_quantize_cuda(torch.zeros((1, 8, 8), dtype=torch.int16), q)
    with pytest.raises(ValueError, match="multiples of 8"):
        cuda_dct.fdct_quantize_cuda(torch.zeros((1, 8, 12), dtype=torch.uint8), q)
    with pytest.raises(ValueError, match="out must be"):
        cuda_dct.fdct_quantize_cuda(torch.zeros((1, 8, 8), dtype=torch.uint8), q,
                                    out=torch.empty((1, 1, 2, 64), dtype=torch.int16))


def test_quantizer_rounds_half_away_at_exact_multiples():
    # A flat block puts every sample's energy in the DC term: t = 64 * 8 *
    # (v - 128) / 8 before quantization, so the divisor boundary is hit.
    for v, qv in ((0, 1), (255, 2), (130, 16), (126, 16), (192, 255)):
        q = np.full(64, qv)
        grid = torch.full((1, 8, 8), v, dtype=torch.uint8)
        got = int(tje.fdct_quantize_plain(grid, q)[0, 0, 0, 0])
        want = np.asarray(hje.fdct_quantize(jnp.full((1, 8, 8), v, jnp.int32), q))[0, 0, 0, 0]
        assert got == int(want)
