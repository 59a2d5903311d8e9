"""K7's forms, restated in plain PyTorch, against hipe_tpu's fDCT + quantize
(its Pallas kernel in interpret mode and its XLA graph) and the port's plain
version, exactly.

``hipe_tpu_torch/csrc/dct_blocks.cu`` computes the fDCT + quantize of kernel
K7 in forms other than the definition's:

- The quantizer divides by no runtime divisor. For each table position the
  host computes, from ``qd = q << 3`` and ``L = floor(log2 qd)``,
  ``mul = ceil(2^(31+L) / qd)``, ``shift = L - 1`` and ``half = qd >> 1``;
  the kernel takes ``v = umulhi(|t| + half, mul) >> shift`` and puts the sign
  back. Both sides are step functions of ``a = |t| + half`` that never fall,
  so agreeing at ``a = 0``, at every step ``a = k*qd - 1`` and ``a = k*qd``
  and at the top of the range proves them equal on all of it.
- What ``a`` reaches: samples 0..255 give ``|t| <= 8192``, so
  ``a <= 8192 + (65535 << 2) < 2^19``; each coefficient's extreme is taken
  on the block of 0s and 255s by the signs of its weights.
- The level shift is one subtract a block: the row pass runs on unshifted
  samples (each row's DC 4096 too large), and the block's DC is 8192 too
  large.
- A thread a block: thread blocks of ``gx`` by ``128 / gx`` threads, ``gx``
  the least power of two >= Wb up to 128, block rows ``b * Hb + by`` over
  the grid's x, tiles of block columns over its y (at most 65535 of them,
  the rest walked), no division; each warp stores its 32 blocks through
  shared memory, 4 whole blocks an instruction.

Here each form runs as the kernel runs it, over every thread at once, and
the result must be hipe_tpu's integers and the plain version's, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import jpeg_encode as hje
from hipe_tpu.ops import pallas_dct as hpd
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.ops import jpeg_encode as tje

THREADS = 128  # dct_blocks.cu: kK7Threads
GRID_Y = 65535  # the most tiles the grid's y holds; the kernel walks the rest
DC_SHIFT = 8192  # kDcShift
T_MAX = 8192  # the largest |t|: the DC of a block of 0s
A_BOUND = 1 << 19  # a = |t| + half stays below it


# ---- the quantizer ----


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """make_quant_table's ``while (qd >> (l + 1)) ++l``, elementwise."""
    l = torch.zeros_like(x)
    while True:
        more = (x >> (l + 1)) > 0
        if not more.any():
            return l
        l += more.long()


def quant_constants(q) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """make_quant_table: (mul, half, shift) int64 for the table entries q."""
    q = torch.as_tensor(np.asarray(q, dtype=np.int64))
    qd = q << 3
    l = _floor_log2(qd)
    mul = ((torch.ones_like(l) << (31 + l)) + qd - 1) // qd
    return mul, qd >> 1, l - 1


def quantize_form(t: torch.Tensor, mul, half, shift) -> torch.Tensor:
    """quantize(): umulhi(|t| + half, mul) >> shift, the sign put back."""
    v = (((t.abs() + half) * mul) >> 32) >> shift
    return torch.where(t < 0, -v, v)


# ---- the block ----


def _pass_weights(final: bool) -> torch.Tensor:
    """(8, 8) int64: output k's weight on input i of one fDCT pass before its
    DESCALE, read from the port's pass on one-hot inputs of 2^16 (each
    output is then the weight times a power of two, exactly)."""
    hot = torch.eye(8, dtype=torch.int32) << 16
    out = torch.stack(tje._fdct_1d([hot[:, i] for i in range(8)], final)).long()
    even = torch.tensor([k in (0, 4) for k in range(8)])[:, None]
    scale = torch.where(even, 1 << 14 if final else 1 << 18, 2 if final else 1 << 5)
    assert torch.equal(out % scale, torch.zeros_like(out))
    return out // scale


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def coefficient_ranges() -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row min, row max) of the row pass over level-shifted rows of
    [-128, 127], and (min, max) (8, 8) of each coefficient over all blocks.
    Each pass output is a DESCALE (which never falls) of a weighted sum, and
    the rows are independent, so each extreme is the extreme weighted sum,
    taken on samples at -128 or 127 by the signs of the weights."""
    w_row, w_col = _pass_weights(False), _pass_weights(True)
    even = torch.tensor([k in (0, 4) for k in range(8)])
    hi = torch.where(w_row > 0, w_row * 127, w_row * -128).sum(1)
    lo = torch.where(w_row > 0, w_row * -128, w_row * 127).sum(1)
    r_max = torch.where(even, hi << 2, _descale(hi, 11))
    r_min = torch.where(even, lo << 2, _descale(lo, 11))
    wc = w_col[:, :, None]  # (u, r, v)
    hi = torch.where(wc > 0, wc * r_max, wc * r_min).sum(1)
    lo = torch.where(wc > 0, wc * r_min, wc * r_max).sum(1)
    t_max = torch.where(even[:, None], _descale(hi, 2), _descale(hi, 15))
    t_min = torch.where(even[:, None], _descale(lo, 2), _descale(lo, 15))
    return r_min, r_max, t_min, t_max


def extreme_blocks() -> torch.Tensor:
    """(130, 8, 8) uint8: for each coefficient (u, v) the block of 0s and
    255s by the signs of its weights (its largest value), the complement (its
    least), a block of 0s and one of 255s."""
    w_row, w_col = _pass_weights(False), _pass_weights(True)
    top = torch.stack([(w_col[u][:, None] > 0) == (w_row[v][None, :] > 0)
                       for u in range(8) for v in range(8)]).to(torch.uint8) * 255
    return torch.cat([top, 255 - top, torch.zeros((1, 8, 8), dtype=torch.uint8),
                      torch.full((1, 8, 8), 255, dtype=torch.uint8)])


def block_form(x: torch.Tensor, qtable) -> torch.Tensor:
    """(n, 8, 8) unshifted samples -> (n, 8, 8) int16 coefficients, as one
    thread computes them: the row pass on each row, the column pass on each
    column, the DC less 8192, the quantizer by its constants, two columns'
    int16 a word (byte permute 0x5410) and the words as int16 again."""
    x = x.to(torch.int32)
    ws = torch.stack(tje._fdct_1d([x[:, :, c] for c in range(8)], final=False), dim=-1)
    cols = []
    for v in range(8):
        col = tje._fdct_1d([ws[:, r, v] for r in range(8)], final=True)
        if v == 0:
            col[0] = col[0] - DC_SHIFT
        cols.append(torch.stack(col, dim=-1))
    t = torch.stack(cols, dim=-1).long()  # (n, u, v)
    mul, half, shift = (c.reshape(8, 8) for c in quant_constants(qtable))
    q = quantize_form(t, mul, half, shift)
    words = (q[..., 0::2] & 0xFFFF) | ((q[..., 1::2] & 0xFFFF) << 16)
    return torch.from_numpy(words.to(torch.int64).numpy().astype(np.uint32).view(np.int16))


# ---- the thread map ----


def k7_launch(b: int, hb: int, wb: int, grid_y: int = GRID_Y) -> dict:
    """k7_launch: block (gx, gy), grid, block rows and tiles."""
    gx = 1
    while gx < wb and gx < THREADS:
        gx *= 2
    gy = THREADS // gx
    bands, tiles = b * hb, -(-wb // gx)
    return {"gx": gx, "gy": gy, "bands": bands, "tiles": tiles,
            "grid": (-(-bands // gy), min(tiles, grid_y))}


def thread_steps(b: int, hb: int, wb: int, grid_y: int = GRID_Y):
    """Each pass of the kernel's tile loop over every thread at once: (cta x,
    cta y, linear thread, band, bx, live) flat tensors, threads in launch
    order; a pass runs where its tile is below ``tiles``."""
    lay = k7_launch(b, hb, wb, grid_y)
    gx, gy = lay["gx"], lay["gy"]
    cx, cy, lin = torch.meshgrid(torch.arange(lay["grid"][0]), torch.arange(lay["grid"][1]),
                                 torch.arange(THREADS), indexing="ij")
    cx, cy, lin = cx.reshape(-1), cy.reshape(-1), lin.reshape(-1)
    x, y = lin % gx, lin // gx
    band = cx * gy + y
    tile = cy.clone()
    while True:
        on = tile < lay["tiles"]
        if not on.any():
            return
        bx = tile * gx + x
        live = on & (band < lay["bands"]) & (bx < wb)
        yield cx[on], cy[on], lin[on], band[on], bx[on], live[on]
        tile = tile + lay["grid"][1]


def k7_form(grid: torch.Tensor, qtable, grid_y: int = GRID_Y) -> torch.Tensor:
    """The kernel over every thread: each live thread's 8 rows gathered by
    the addresses it loads, its block computed, and the warp's staged stores
    (step s, lane: row lane & 7 of lane 4s + lane >> 3's block) scattered by
    the addresses they write. Unwritten coefficients stay at -32768."""
    b, h, w = grid.shape
    hb, wb = h // 8, w // 8
    pitch = wb * 8
    flat = grid.reshape(-1)
    out = torch.full((b * hb * wb * 64,), -32768, dtype=torch.int16)
    r, c = torch.arange(8)[:, None], torch.arange(8)[None, :]
    for _, _, lin, band, bx, live in thread_steps(b, hb, wb, grid_y):
        base = torch.where(live, band * 8 * pitch + bx * 8, 0)
        samples = flat[base[:, None, None] + r * pitch + c]
        rows = block_form(samples, qtable).reshape(-1, 8, 8)  # (thread, row u, 8)
        blk = torch.where(live, band * wb + bx, -1)
        assert len(lin) % 32 == 0
        warp_of = torch.arange(len(lin)) // 32 * 32  # a warp: 32 threads in launch order
        lane = lin % 32
        for s in range(8):
            src = warp_of + 4 * s + (lane >> 3)
            k, u = blk[src], lane & 7
            ok = k >= 0
            dst = (k[ok] * 64 + u[ok] * 8)[:, None] + torch.arange(8)
            out[dst] = rows[src[ok], u[ok]]
    return out.reshape(b, hb, wb, 64)


# ---- the tests ----


def _table(name: str, rng) -> np.ndarray:
    if name == "all 1":
        return np.ones(64, dtype=np.int64)
    if name == "all 65535":
        return np.full(64, 65535, dtype=np.int64)
    if name.startswith("q"):
        quality, part = name[1:].split()
        return np.asarray(tjpeg.quality_tables(int(quality))[part == "chroma"], dtype=np.int64)
    q = rng.integers(1, 65536 if name == "random 16-bit" else 256, 64)
    q[:2] = (65535, 1)
    return q


def _grids(b: int, hb: int, wb: int, kind: str, rng) -> np.ndarray:
    """(b, hb*8, wb*8) uint8: random samples, flat 0/255 blocks, or the
    extreme blocks in turn."""
    if kind == "random":
        return rng.integers(0, 256, (b, hb * 8, wb * 8)).astype(np.uint8)
    if kind == "flat":
        flat = rng.integers(0, 2, (b * hb * wb, 1, 1)) * 255
        blocks = np.broadcast_to(flat, (b * hb * wb, 8, 8))
    else:
        ext = extreme_blocks().numpy()
        blocks = ext[(np.arange(b * hb * wb) + rng.integers(0, len(ext))) % len(ext)]
    return np.ascontiguousarray(blocks.reshape(b, hb, wb, 8, 8).transpose(0, 1, 3, 2, 4)
                                .reshape(b, hb * 8, wb * 8).astype(np.uint8))


@pytest.mark.parametrize("q_lo", range(1, 65536, 8192))
def test_quantizer_is_exact_at_every_step_for_every_table_entry(q_lo):
    q = torch.arange(q_lo, min(q_lo + 8192, 65536), dtype=torch.int64)
    mul, half, shift = quant_constants(q)
    qd = q << 3
    assert torch.equal(half, q << 2)
    assert bool(((mul > 1 << 30) & (mul <= 1 << 31)).all())
    assert int(shift.min()) >= 2 and int(shift.max()) <= 17
    steps = (A_BOUND - 1) // qd  # k * qd < 2^19 for k <= steps
    rep = torch.repeat_interleave(torch.arange(len(q)), steps)
    k = torch.cat([torch.arange(1, int(n) + 1) for n in steps])
    a = torch.cat([k * qd[rep], k * qd[rep] - 1,
                   torch.zeros_like(q), torch.full_like(q, A_BOUND - 1)])
    idx = torch.cat([rep, rep, torch.arange(len(q)), torch.arange(len(q))])
    got = ((a * mul[idx]) >> 32) >> shift[idx]
    assert torch.equal(got, a // qd[idx])
    # The products stay below 2^64 and a below 2^32: umulhi's arithmetic.
    assert int(a.max()) < A_BOUND and int(mul.max()) * A_BOUND < 1 << 64


@pytest.mark.parametrize("q", [1, 2, 3, 7, 8, 100, 255, 256, 4095, 4096, 32767, 32768, 65534,
                               65535])
def test_quantizer_rounds_half_away_and_restores_the_sign(q):
    qd = q << 3
    mul, half, shift = quant_constants([q])
    k = torch.arange(0, T_MAX // qd + 2)
    # a = |t| + half at a step, just below it and just above it; and every t
    # the fDCT can produce.
    mag = torch.cat([k * qd - half, k * qd - half - 1, k * qd - half + 1,
                     torch.arange(0, T_MAX + 1)])
    mag = mag[(mag >= 0) & (mag <= T_MAX)]
    t = torch.cat([mag, -mag])
    got = quantize_form(t, mul, half, shift)
    want = torch.where(t < 0, -((-t + half) // qd), (t + half) // qd)
    assert torch.equal(got, want)
    assert torch.equal(got.abs(), ((t.abs() + half) // qd))  # half rounds away from zero
    jax_got = np.asarray(hpd._quantize_exact(jnp.asarray(t.numpy().astype(np.int32)), qd))
    np.testing.assert_array_equal(got.numpy(), jax_got)


def test_fdct_range_gives_the_stated_bound():
    r_min, r_max, t_min, t_max = coefficient_ranges()
    assert int(torch.maximum(r_max, -r_min).max()) == 4096  # the row's DC, (8 * 128) << 2
    assert int(t_min[0, 0]) == -T_MAX and int(t_max[0, 0]) == 8128
    ac = torch.maximum(t_max, -t_min).reshape(-1)[1:]
    assert int(ac.max()) == 8160
    assert T_MAX + (65535 << 2) < A_BOUND
    # The extreme blocks take each coefficient to its extreme, in the plain
    # version and in the kernel's form.
    ext = extreme_blocks()
    t = tje._fdct_planes_core(ext.to(torch.int32) - 128).reshape(130, 64).long()
    idx = torch.arange(64)
    assert torch.equal(t[idx, idx], t_max.reshape(-1))
    assert torch.equal(t[64 + idx, idx], t_min.reshape(-1))
    assert int(t.abs().max()) == T_MAX
    ones = np.ones(64)
    assert torch.equal(block_form(ext, ones).reshape(130, 64),
                       tje.fdct_quantize_plain(ext, ones).reshape(130, 64))


def test_level_shift_is_one_subtract_from_the_dc():
    rng = np.random.default_rng(11)
    x = torch.cat([extreme_blocks(), torch.from_numpy(
        rng.integers(0, 256, (500, 8, 8)).astype(np.uint8))]).to(torch.int32)
    raw = torch.stack(tje._fdct_1d([x[:, :, c] for c in range(8)], final=False), dim=-1)
    shifted = torch.stack(tje._fdct_1d([x[:, :, c] - 128 for c in range(8)], final=False),
                          dim=-1)
    diff = raw - shifted
    assert bool((diff[..., 0] == 4096).all()) and bool((diff[..., 1:] == 0).all())
    got = block_form(x, np.ones(64)).reshape(-1, 64)
    assert torch.equal(got, tje.fdct_quantize_plain(x.to(torch.uint8), np.ones(64))
                       .reshape(-1, 64))


@pytest.mark.parametrize("shape", [(1, 1, 1), (8, 1, 1), (1, 282, 500), (3, 5, 7), (2, 4, 16),
                                   (5, 32, 32), (7, 16, 16), (4, 3, 130), (6, 2, 33),
                                   (1, 1, 300), (2, 7, 128), (1, 2, 129)])
@pytest.mark.parametrize("grid_y", [GRID_Y, 2, 3])
def test_thread_map_takes_each_block_once(shape, grid_y):
    b, hb, wb = shape
    lay = k7_launch(b, hb, wb, grid_y)
    assert lay["gx"] * lay["gy"] == THREADS and lay["gx"] >= min(wb, THREADS)
    seen = torch.zeros(b * hb * wb, dtype=torch.int64)
    rows_out = torch.zeros(b * hb * wb * 8, dtype=torch.int64)
    for _, _, lin, band, bx, live in thread_steps(b, hb, wb, grid_y):
        blk = band[live] * wb + bx[live]
        seen.index_add_(0, blk, torch.ones_like(blk))
        # The input rows a thread loads are its block's, and its output block
        # is the block's place in (B, Hb, Wb, 64).
        img, by = band[live] // hb, band[live] % hb
        assert torch.equal(blk, (img * hb + by) * wb + bx[live])
        # Each store step writes row lane & 7 of lane 4s + lane >> 3's block:
        # over the 8 steps every row of every live block of the warp, once.
        k = torch.where(live, band * wb + bx, -1)
        lane = lin % 32
        warp = torch.arange(len(lin)) // 32 * 32
        for s in range(8):
            src = k[warp + 4 * s + (lane >> 3)]
            ok = src >= 0
            rows_out.index_add_(0, src[ok] * 8 + (lane & 7)[ok], torch.ones_like(src[ok]))
    assert bool((seen == 1).all())
    assert bool((rows_out == 1).all())


def test_a_warps_store_covers_four_whole_blocks():
    # The codec's luma (Wb = 32) and chroma (Wb = 16) grids: each store
    # instruction of a warp writes 512 contiguous bytes.
    for wb in (32, 16):
        for _, _, lin, band, bx, live in thread_steps(4, 8, wb):
            k = torch.where(live, band * wb + bx, -1).reshape(-1, 32)
            lane = torch.arange(32)
            for s in range(8):
                addr = (k[:, 4 * s + (lane >> 3)] * 64 + (lane & 7) * 8) * 2  # bytes
                assert bool((addr[:, 1:] - addr[:, :-1] == 16).all())


@pytest.mark.parametrize("shape,table", [
    ((1, 1, 1), "all 1"),
    ((3, 5, 7), "all 65535"),
    ((2, 4, 16), "q90 luma"),
    ((3, 32, 32), "random 16-bit"),
    ((1, 282, 500), "q50 chroma"),
    ((4, 3, 130), "random 8-bit"),
])
def test_k7_form_matches_hipe_tpu_and_the_plain_version(shape, table):
    b, hb, wb = shape
    rng = np.random.default_rng(hb * 1000 + wb)
    q = _table(table, rng)
    img = np.concatenate([_grids(b, hb, wb, kind, rng) for kind in ("random", "flat", "extreme")])
    got = k7_form(torch.from_numpy(img), q, grid_y=GRID_Y if wb < 100 else 1)
    assert got.shape == (3 * b, hb, wb, 64) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), tje.fdct_quantize_plain(torch.from_numpy(img), q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        hje.fdct_quantize(jnp.asarray(img, jnp.int32), q)))
    planes, phb, pwb = hje._planes_from_grid(jnp.asarray(img, jnp.uint8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        hpd.fdct_quantize_planes_pallas(planes, phb, pwb, q, interpret=True)))


@pytest.mark.parametrize("table", ["all 1", "all 65535", "q1 luma", "q100 chroma"])
def test_flat_and_extreme_blocks_at_the_table_ends(table):
    rng = np.random.default_rng(len(table))
    q = _table(table, rng)
    ext = extreme_blocks()
    img = ext.reshape(2, 65, 8, 8).transpose(1, 2).reshape(2, 8, 65 * 8).contiguous()
    got = k7_form(img, q)
    want = tje.fdct_quantize_plain(img, q)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        hje.fdct_quantize(jnp.asarray(img.numpy(), jnp.int32), q)))
    if table == "all 1":
        # q = 1: qd = 8, so the DC of the block of 0s is -8192 / 8.
        assert int(got.reshape(-1, 64)[128, 0]) == -1024
    if table == "all 65535":
        # The largest divisor: every coefficient rounds to 0.
        assert not bool(got.any())
