"""K1's register forms, restated in plain PyTorch, against hipe_tpu's blur
kernels, the port's plain blur and the NumPy oracle, exactly.

``hipe_tpu_torch/csrc/blur_planar.cu`` computes the binomial blur in a form
other than the definition. The stream's runs of 8 bytes are taken in
(plane, run) order, and a warp owns 32 consecutive ones, one a lane, which
may span planes, and a band of ``rows_per_block`` output rows, which it
walks down. A lane's window is its run and the words of its neighbours'
runs beside it: by shuffle from the lanes beside it, loaded by the warp's
outer lanes, and at a row's first and last run, wherever it sits in the
warp, made from the run's own edge pixel (aligned rows) or loaded as
clamped bytes (the rest); a shuffle across a plane's edge is never used.
Each window row is summed across once, two outputs a 32-bit word in 16-bit
lanes, from byte pairs at offsets ``k*C``; the last ``2r+1`` row sums rotate
through ``2r+1`` slots and are summed down in 16-bit lanes (r <= 2) or
32-bit lanes (r >= 3), then ``>> 4r``. The tail run of a row is masked.
Where ``r*C`` bytes do not fit one neighbour run, or C is not 1-4, a run
form sums each byte's taps from clamped loads instead.

Here each piece runs as the kernel runs it, over every lane and band at
once, and the result must be hipe_tpu's integers (its Pallas kernels in
interpret mode, as its own tests run them), the port's plain blur's and the
oracle's, bit for bit.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import blur as jblur
from hipe_tpu.ops import pallas_blur
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import cuda_blur, planar
from hipe_tpu_torch.ops import reference as tref

RUN = 8  # bytes a lane owns: lanes::kRun
WARP = 32  # runs a warp
OUT_PAIRS = (0, 1, 4, 5)  # first column of output pair k: columns (o, o + 2)


def _rows(b, h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w * c), dtype=np.uint8)


def _pairs_form(r: int, c: int) -> bool:
    """Whether K1 takes the pairs form: C known at compile time (1-4) and
    r*C bytes a side within one neighbour run."""
    return 1 <= c <= 4 and r * c <= RUN


def _clamp_byte(p: torch.Tensor, length: int, c: int) -> torch.Tensor:
    """blur_planar.cu:clamp_byte: byte p of a row, clamped a whole pixel."""
    return torch.where(p < 0, p % c, torch.where(p >= length, length - c + (p - length) % c, p))


def _map(length: int, n: int = 1):
    """The lanes of K1's warps over n planes of rows of ``length`` bytes:
    the stream's runs in (plane, run) order, 32 a warp, lane = index % 32.
    Per lane: its plane, its run's first byte, whether it holds a run (lanes
    past the stream's last run take the last run's place and store
    nothing), and whether it is ``left`` (lane 0 or its row's first run: no
    lane holds the run left of it) and ``right`` (lane 31 or its row's last
    run)."""
    runs = -(-length // RUN)
    total = n * runs
    f = torch.arange(-(-total // WARP) * WARP)
    lane = f % WARP
    active = f < total
    f = f.clamp(max=total - 1)
    plane, run = f // runs, f % runs
    return (plane, RUN * run, active, (lane == 0) | (run == 0),
            (lane == WARP - 1) | (run == runs - 1))


def _shuffle(v: torch.Tensor, delta: int) -> torch.Tensor:
    """__shfl_up_sync (delta -1) or __shfl_down_sync (+1) over the lanes of
    v (lanes, ...): each lane reads lane + delta of its warp, or its own
    value past the warp's edge."""
    idx = torch.arange(v.shape[0])
    src = idx + delta
    return v[torch.where((src // WARP == idx // WARP) & (src >= 0), src, idx)]


def _units(n: int, length: int, ho: int, rows_per_block: int):
    """launch_kc's warp units and blur_u8_kernel's reading of each, over
    (chunk of segs groups, band, group of the chunk), the group fastest,
    segs = ceil(runs a row / 32): per unit its group and band, and the
    stream's groups (units of a group past them pad the last chunk)."""
    runs = -(-length // RUN)
    segs, groups = -(-runs // WARP), -(-n * runs // WARP)
    tiles = -(-ho // min(rows_per_block, ho))
    u = torch.arange(-(-groups // segs) * segs * tiles)
    return u // segs // tiles * segs + u % segs, u // segs % tiles, groups


def _launch_lanes(n: int, length: int, ho: int, rows_per_block: int):
    """launch_kc's warps that walk a band over n planes of rows of
    ``length`` bytes, their lanes, and the lanes holding a run (each run of
    the stream once a band); the warps that pad the last chunk return at
    once and are not counted."""
    runs, bands = n * -(-length // RUN), -(-ho // min(rows_per_block, ho))
    warps = -(-runs // WARP) * bands
    return warps, WARP * warps, runs * bands


def _window(line: torch.Tensor, c: int, r: int, vec: bool) -> torch.Tensor:
    """(lanes, 8 + 8*side) int64: each lane's window bytes q = -4 side ..
    8 + 4 side around its run, over the same row of the B planes of line
    (B, length), assembled as the pairs form assembles it."""
    length = line.shape[-1]
    side = (r * c + 3) // 4
    plane, x, _, left, right = _map(length, line.shape[0])
    k8, ks = torch.arange(RUN), torch.arange(4 * side)
    pl = plane[:, None]
    own = line[pl, _clamp_byte(x[:, None] + k8, length, c)]
    up = _shuffle(own, -1)[..., RUN - 4 * side:]  # __shfl_up_sync
    down = _shuffle(own, 1)[..., :4 * side]  # __shfl_down_sync
    if vec:
        # Aligned rows: the outer lanes load the words beside their run; at
        # a row's ends they make them from the run's own edge pixel.
        loaded_l = line[pl, (x[:, None] - 4 * side + ks).clamp(0, length - 1)]
        loaded_r = line[pl, (x[:, None] + RUN + ks).clamp(0, length - 1)]
        before = own[..., (ks - 4 * side) % c]  # before_row: channel q mod C
        after = own[..., RUN - c + ks % c]  # after_row: the last pixel's
        lft = torch.where((left & (x > 0))[:, None], loaded_l,
                          torch.where(left[:, None], before, up))
        rgt = torch.where((right & (x + RUN < length))[:, None], loaded_r,
                          torch.where(right[:, None], after, down))
    else:
        # Unaligned rows: the outer lanes load their neighbour run as
        # clamped bytes.
        loaded_l = line[pl, _clamp_byte(x[:, None] - RUN + k8, length, c)][..., RUN - 4 * side:]
        loaded_r = line[pl, _clamp_byte(x[:, None] + RUN + k8, length, c)][..., :4 * side]
        lft = torch.where(left[:, None], loaded_l, up)
        rgt = torch.where(right[:, None], loaded_r, down)
    return torch.cat([lft, own, rgt], dim=-1).long()


def _pair(win: torch.Tensor, q: int, side: int) -> torch.Tensor:
    """Window bytes q and q + 2 as one word of two 16-bit lanes."""
    return win[..., q + 4 * side] | win[..., q + 4 * side + 2] << 16


def _row_sum(line: torch.Tensor, c: int, r: int, vec: bool) -> torch.Tensor:
    """(lanes, 4) int64: each lane's row sum, output pairs in 16-bit lanes."""
    taps = [math.comb(2 * r, j) for j in range(2 * r + 1)]
    if _pairs_form(r, c):
        side = (r * c + 3) // 4
        win = _window(line, c, r, vec)
        sums = [sum(t * _pair(win, o + (j - r) * c, side) for j, t in enumerate(taps))
                for o in OUT_PAIRS]
    else:
        # The run form: each byte's taps loaded one by one, a pixel clamped.
        length = line.shape[-1]
        w = length // c
        plane, x, _, _, _ = _map(length, line.shape[0])
        b = (x[:, None] + torch.arange(RUN)).clamp(max=length - 1 + RUN)
        px, ch = b // c, b % c
        v = sum(t * line[plane[:, None], (px + j - r).clamp(0, w - 1) * c + ch].long()
                for j, t in enumerate(taps))
        sums = [v[..., o] | v[..., o + 2] << 16 for o in OUT_PAIRS]
    out = torch.stack(sums, dim=-1)
    assert int((out & 0xFFFF).max()) <= 255 * 4 ** r and int((out >> 16).max()) <= 255 * 4 ** r
    return out


def _sum_down(ring: list, p: int, r: int) -> torch.Tensor:
    """(lanes, 8) uint8: output row p's runs from the ring's slots
    (p + j) % N, j = 0 .. 2r: sum_down in 16-bit or 32-bit lanes, >> 4r,
    and pack_pairs's byte order."""
    n = 2 * r + 1
    taps = [math.comb(2 * r, j) for j in range(n)]
    if r <= 2:
        acc = sum(t * ring[(p + j) % n] for j, t in enumerate(taps))
        lo, hi = acc & 0xFFFF, acc >> 16
        assert int(lo.max()) < 1 << 16  # no carry between the lanes
        word = acc >> (4 * r)
        o_lo, o_hi = word & 0xFF, (word >> 16) & 0xFF
        assert torch.equal(o_lo, lo >> (4 * r)) and torch.equal(o_hi, hi >> (4 * r))
    else:
        lo = sum(t * (ring[(p + j) % n] & 0xFFFF) for j, t in enumerate(taps))
        hi = sum(t * (ring[(p + j) % n] >> 16) for j, t in enumerate(taps))
        o_lo, o_hi = lo >> (4 * r), hi >> (4 * r)
    assert int(o_lo.max()) <= 255 and int(o_hi.max()) <= 255
    # pack_pairs: bytes (o0.lo, o1.lo, o0.hi, o1.hi, o2.lo, o3.lo, o2.hi, o3.hi)
    order = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1)]
    return torch.stack([(o_lo, o_hi)[half][..., k] for k, half in order], dim=-1).to(torch.uint8)


def k1_form(rows: torch.Tensor, c: int, r: int, *, h_pad: bool = True,
            rows_per_block: int = 16, vec: bool | None = None) -> torch.Tensor:
    """K1 over rows (B, H, W*C) (planar planes are C = 1) as the kernel
    computes it: the B images' runs in (plane, run) order, 32 a warp, each
    band walked down, each window row loaded once and summed across into
    slot i % N, each output row summed down from the slots, each lane's run
    stored with its tail masked, and nothing stored by a lane past the
    stream's last run."""
    bsz, h, length = rows.shape
    vec = length % RUN == 0 if vec is None else vec
    ho = h if h_pad else h - 2 * r
    row_off = -r if h_pad else 0
    n = 2 * r + 1
    plane, xs, active, _, _ = _map(length, bsz)
    keep = (length - xs).clamp(max=RUN)
    out = torch.full((bsz, ho, -(-length // RUN) * RUN + RUN), 0xAB, dtype=torch.uint8)
    rpb = min(rows_per_block, ho)
    for y0 in range(0, ho, rpb):
        def row_sum(i, y0=y0):
            return _row_sum(rows[:, min(max(y0 + row_off + i, 0), h - 1)], c, r, vec)

        ring = [None] * n
        for i in range(2 * r):
            ring[i % n] = row_sum(i)
        for p in range(min(rpb, ho - y0)):
            ring[(p + 2 * r) % n] = row_sum(p + 2 * r)
            run = _sum_down(ring, p, r)
            for k in range(RUN):
                m = active & (keep > k)  # the masked tail, the idle lanes
                out[plane[m], y0 + p, xs[m] + k] = run[m, k]
    assert torch.all(out[..., length:] == 0xAB)  # nothing stored past the row
    return out[..., :length]


def _blur(x: np.ndarray, c: int, r: int, **kw) -> np.ndarray:
    return k1_form(torch.from_numpy(x), c, r, **kw).numpy()


def _hipe_tpu_rows(x: np.ndarray, c: int, r: int, h_pad: bool) -> np.ndarray:
    """hipe_tpu's rows blur: gaussian_blur_rows_pallas in interpret mode
    where it takes the geometry (H a multiple of 8, W*C <= 2048), else its
    XLA rows op."""
    _, h, lane = x.shape
    if pallas_blur.nhwc_pallas_eligible(h, lane // c, c):
        return np.asarray(pallas_blur.gaussian_blur_rows_pallas(
            jnp.asarray(x), c, r, h_pad=h_pad, interpret=True))
    return np.asarray(jblur.ROWS_FILTERS[f"gaussian{2 * r + 1}"](jnp.asarray(x), c, h_pad=h_pad))


def _plain_rows(x: np.ndarray, c: int, r: int, h_pad: bool) -> np.ndarray:
    return tblur.gaussian_blur_rows(torch.from_numpy(x), c, r, h_pad=h_pad).numpy()


@pytest.mark.parametrize("length", [1, 7, 8, 40, 255, 256, 257, 768, 1100, 72, 264, 320])
def test_thread_map_covers_each_byte_once_in_segments_of_32_runs(length):
    """Over n planes, the active lanes hold each byte of each plane's row
    once; only the last warp has idle lanes; left and right mark each warp's
    outer lanes and each row's ends; where a row's runs are a multiple of
    32, each warp holds one segment of one plane, lane l its run 32 s + l."""
    runs = -(-length // RUN)
    for n in (1, 2, 3, 7, 33):
        plane, x, active, left, right = _map(length, n)
        lanes = plane.numel()
        assert lanes == -(-n * runs // WARP) * WARP
        assert int(active.sum()) == n * runs and bool(active[:n * runs].all())
        assert lanes - n * runs < WARP  # idle lanes: the last warp's tail
        byte = (plane[active, None] * length + x[active, None] + torch.arange(RUN)).flatten()
        inside = (x[active, None] + torch.arange(RUN)).flatten() < length
        assert torch.equal(byte[inside], torch.arange(n * length))
        lane = torch.arange(lanes) % WARP
        first, last = (x == 0) & active, (x == RUN * (runs - 1)) & active
        assert torch.equal(left & active, ((lane == 0) | first) & active)
        assert torch.equal(right & active, ((lane == WARP - 1) | last) & active)
        assert int(first.sum()) == n and int(last.sum()) == n
        warp_plane = plane.view(-1, WARP)
        if runs % WARP == 0:
            assert bool((warp_plane == warp_plane[:, :1]).all())
            assert torch.equal(x.view(-1, WARP) // RUN % WARP, lane.view(-1, WARP))
        else:
            # Some warp spans two planes or more.
            assert bool((warp_plane != warp_plane[:, :1]).any()) == (n > 1)
    for ho, rpb in ((1, 16), (37, 8), (256, 64), (256, 256)):
        tiles = -(-ho // min(rpb, ho))
        bands = [min(rpb, ho - y0) for y0 in range(0, ho, min(rpb, ho))]
        assert len(bands) == tiles and sum(bands) == ho


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("r,c", [(r, c) for r in (1, 2, 3, 4) for c in (1, 2, 3, 4)
                                 if _pairs_form(r, c)])
def test_neighbour_exchange_is_the_clamped_row(r, c, vec):
    """Each lane's window (shuffles, the outer lanes' loads, the edge
    pixel's bytes at the row's ends) is the row clamped a pixel at a time."""
    side = (r * c + 3) // 4
    for w, n in itertools.product((1, 2, 3, 5, 8, 64, 85, 257, 40, 72, 264, 320), (2, 1, 5, 33)):
        line = torch.from_numpy(_rows(n, 1, w, c, seed=w + c + n)[:, 0])
        length = line.shape[-1]
        if vec and length % RUN:
            continue
        plane, x, active, _, _ = _map(length, n)
        win = _window(line, c, r, vec)
        q = x[:, None] + torch.arange(-4 * side, RUN + 4 * side)
        want = line[plane[:, None], _clamp_byte(q, length, c)].long()
        np.testing.assert_array_equal(win[active].numpy(), want[active].numpy(),
                                      err_msg=f"w={w} n={n}")


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_lanes_hold_their_sums(r):
    """A row sum is at most 255 * 4^r <= 65280, a 16-bit lane; summed down
    it stays within one up to r = 2 (65280) and not beyond (r = 3: 1044480),
    which is why gaussian7 and gaussian9 sum down in 32-bit lanes."""
    assert 255 * 4 ** r < 1 << 16
    assert (255 * 4 ** (2 * r) < 1 << 16) == (r <= 2)
    x = np.full((1, 2 * r + 3, 2 * RUN), 255, dtype=np.uint8)
    np.testing.assert_array_equal(_blur(x, 1, r), x)  # asserts the lanes inside


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_form_matches_hipe_tpu_rows_kernel(r, c, h_pad):
    """Widths 1-5, 7, 255 and 257 pixels of C channels, against
    gaussian_blur_rows_pallas in interpret mode (its XLA rows op where the
    kernel does not take W*C) and the plain rows blur; ragged bands
    (rows_per_block 5)."""
    h = 16
    for w in (1, 2, 3, 4, 5, 7, 255, 257):
        x = _rows(2, h, w, c, seed=100 * r + 10 * c + w)
        want = _hipe_tpu_rows(x, c, r, h_pad)
        np.testing.assert_array_equal(_plain_rows(x, c, r, h_pad), want)
        got = _blur(x, c, r, h_pad=h_pad, rows_per_block=5)
        np.testing.assert_array_equal(got, want, err_msg=f"w={w}")


@pytest.mark.parametrize("length", [8, 40, 72, 264, 320])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_form_where_warps_span_planes(r, length):
    """Planes whose rows are no multiple of 32 runs, so a warp holds the end
    of one plane's row and the start of the next (a warp of 8-byte rows
    holds 32 planes), and stream sizes that leave the last warp partly
    empty: aligned and as the unaligned path loads them, clamp and valid,
    against the plain planar blur and the oracle; rows of C = 3 at 320
    pixels, an odd image count, against the plain rows blur."""
    for n in (1, 3, 7, 33):
        x = _rows(n, 11, length, 1, seed=n + length + r)
        oracle = np.stack([tref.gaussian_blur_int_oracle(p, r) for p in x])
        for h_pad in (True, False):
            plain = tblur.gaussian_blur_planar(torch.from_numpy(x), r, h_pad=h_pad).numpy()
            np.testing.assert_array_equal(plain, oracle if h_pad else oracle[:, r:11 - r])
            for vec, rpb in ((True, 4), (False, 3), (True, 16)):
                got = _blur(x, 1, r, h_pad=h_pad, rows_per_block=rpb, vec=vec)
                np.testing.assert_array_equal(got, plain, err_msg=f"n={n} {h_pad} {vec} {rpb}")
    if length == 320:
        x = _rows(3, 10, 320, 3, seed=r)
        for vec in (True, False):
            np.testing.assert_array_equal(_blur(x, 3, r, rows_per_block=4, vec=vec),
                                          _plain_rows(x, 3, r, True))


@pytest.mark.parametrize("n,h,row_bytes", [(15000, 240, 320), (15000, 256, 256), (5000, 240, 960),
                                           (5000, 256, 768), (33, 16, 40), (7, 5, 8), (1, 9, 1),
                                           (5, 11, 264), (3, 1, 7)])
def test_launch_lanes_counts_the_warps_and_live_lanes(n, h, row_bytes):
    """_launch_lanes against the kernel's unit decode (_units) and the lane
    map (_map): ceil(n * runs / 32) warps a band, every lane live but the
    last warp's tail; where a row's runs are a multiple of 32, the warps of
    a segment of one row a warp (the map before (plane, run) order)."""
    runs = -(-row_bytes // RUN)
    for radius, h_pad, rpb in itertools.product((1, 4), (True, False), (1, 8, 16, 64, 512)):
        ho = cuda_blur.out_rows(h, radius, h_pad)
        if ho < 1:
            continue
        bands = -(-ho // min(rpb, ho))
        warps, lanes, live = _launch_lanes(n, row_bytes, ho, rpb)
        assert warps == -(-n * runs // WARP) * bands
        assert lanes == WARP * warps and live == n * runs * bands
        assert lanes - live == (-n * runs) % WARP * bands  # the last warp's tail
        segment_warps = n * bands * -(-runs // WARP)
        assert warps <= segment_warps
        if runs % WARP == 0:
            assert warps == segment_warps and live == lanes
        if n * row_bytes <= 4096:
            _, _, active, _, _ = _map(row_bytes, n)
            assert (lanes, live) == (active.numel() * bands, int(active.sum()) * bands)
        # The kernel's units: each (group, band) once, the padding of the
        # last chunk besides (fewer than a chunk's groups a band); where a
        # row's runs are a multiple of 32, unit u is (plane, band, segment)
        # = (u / segs / bands, u / segs % bands, u % segs), as before.
        group, band, groups = _units(n, row_bytes, ho, rpb)
        walks = group < groups
        assert int(walks.sum()) == warps
        assert 0 <= group.numel() - warps < -(-runs // WARP) * bands
        pairs = group[walks] * bands + band[walks]
        assert torch.equal(pairs.sort().values, torch.arange(warps))
        if runs % WARP == 0:
            segs, u = runs // WARP, torch.arange(group.numel())
            assert bool(walks.all())
            assert torch.equal(group // segs, u // segs // bands)  # the plane
            assert torch.equal(group % segs, u % segs) and torch.equal(band, u // segs % bands)
    if (n, h, row_bytes) == (15000, 240, 320):
        # The benchmark's stream at 16 rows a band: 62.5% of the lanes held a
        # run as segments of one row; every lane does now.
        warps, lanes, live = _launch_lanes(n, row_bytes, h, 16)
        assert (warps, live) == (281_250, 9_000_000) and live == lanes
        assert 15000 * 15 * 2 * WARP * 0.625 == live


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_form_matches_rows_kernel_at_768_pixels_and_unaligned(r, c):
    """768 pixels a row (several segments), aligned and as the unaligned
    path loads it, against the rows kernel and the NumPy oracle."""
    x = _rows(1, 8, 768, c, seed=r + c)
    want = _hipe_tpu_rows(x, c, r, True)
    for vec in (True, False):
        np.testing.assert_array_equal(_blur(x, c, r, rows_per_block=3, vec=vec), want)
    oracle = tref.gaussian_blur_int_oracle(x[0].reshape(8, 768, c), r)
    np.testing.assert_array_equal(want[0], oracle.reshape(8, 768 * c))


@pytest.mark.parametrize("c", [1, 3, 9])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_short_planes_clamp_every_window_row(r, c):
    """H below 2r+1 in clamp mode: every window row clamps into the plane.
    hipe_tpu's rows kernel takes no such H (a multiple of 8 only), so the
    form is held against the plain rows blur, which test_torch_rows.py
    holds against hipe_tpu, and against the NumPy oracle."""
    for h in range(1, 2 * r + 1):
        x = _rows(2, h, 13, c, seed=h + r)
        want = _plain_rows(x, c, r, True)
        oracle = np.stack([tref.gaussian_blur_int_oracle(img.reshape(h, 13, c), r)
                           for img in x]).reshape(x.shape)
        np.testing.assert_array_equal(want, oracle)
        np.testing.assert_array_equal(_blur(x, c, r, rows_per_block=1), want)
        np.testing.assert_array_equal(_blur(x, c, r, rows_per_block=16), want)


@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_planar_form_matches_blur_kernels(r, h_pad):
    """Planar planes are rows of C = 1: against _blur_mxu_kernel and
    _blur_kernel (gaussian_blur_planar_pallas, path mxu and vpu, interpret
    mode), the plain planar blur and the oracle; widths 1-5, 7, 53, 257."""
    for w in (1, 2, 3, 4, 5, 7, 53, 257):
        x = _rows(3, 16, w, 1, seed=w * r)
        got = _blur(x, 1, r, h_pad=h_pad, rows_per_block=4)
        for path in ("mxu", "vpu"):
            want = np.asarray(pallas_blur.gaussian_blur_planar_pallas(
                jnp.asarray(x), r, h_pad=h_pad, path=path, interpret=True))
            np.testing.assert_array_equal(got, want, err_msg=f"w={w} {path}")
        plain = tblur.gaussian_blur_planar(torch.from_numpy(x), r, h_pad=h_pad).numpy()
        np.testing.assert_array_equal(got, plain)
        oracle = np.stack([tref.gaussian_blur_int_oracle(p, r) for p in x])
        np.testing.assert_array_equal(got, oracle if h_pad else oracle[:, r:x.shape[1] - r])


def _routed(monkeypatch, names, h, w, **kw):
    """The kernels :func:`planar.filter_planar` sends (1, H, W) planes of
    ``names`` to off the CPU (meta tensors: shapes only)."""
    seen = []
    for kernel, name in (("K1", "gaussian_blur_planar_cuda"), ("K2", "filter_chain_planar_cuda"),
                         ("K3", "rank_chain_planar_cuda"),
                         ("K4/K5", "filter_chain_planar_tiled_cuda")):
        monkeypatch.setattr(planar, name, lambda *a, _k=kernel, **k: seen.append(_k))
    planar.filter_planar(torch.empty((1, h, w), dtype=torch.uint8, device="meta"), names, **kw)
    return seen


def test_k1_takes_no_shared_memory_so_no_width_routes_away(monkeypatch):
    """The row sums live in registers: the router's mirror is 0, so a single
    gaussian stays on K1 at any width and band height; K2's and K3's padded
    buffers still route wide chains tiled."""
    for name in tblur.GAUSSIANS:
        assert planar.fused_shared_bytes(32, 4000, (name,)) == 0
        for h, w in ((256, 256), (256, 768), (2250, 4000), (2250, 12000), (1, 1)):
            for rpb in (None, 1, 16, 256, 2250):
                assert _routed(monkeypatch, (name,), h, w, rows_per_block=rpb) == ["K1"]
    chain = ("gaussian3", "sharpen", "edge")
    assert _routed(monkeypatch, chain, 2250, 4000) == ["K4/K5"]
    assert _routed(monkeypatch, chain, 256, 256) == ["K2"]
    assert _routed(monkeypatch, ("median", "gaussian3"), 256, 256) == ["K3"]
