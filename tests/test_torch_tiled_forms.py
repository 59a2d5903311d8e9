"""The padded 2-D window of K4 and K5, restated in plain PyTorch, against
hipe_tpu's tiled Pallas kernels and the port's plain ops, exactly.

``hipe_tpu_torch/csrc/tiled_lanes.cuh`` runs one stage over tiles of TH x
TW output pixels, TW rounded up to a run of 8. A block stages its window:
plane rows ``[y0 - r, y0 + rows + r)`` clamped into the plane, and in each
the plane columns ``[c0, c0 + pitch)`` clamped into the plane, ``c0`` the
tile's first column less 4 rounded down to 16 and ``pitch``
:func:`hipe_tpu_torch.ops.planar.window_pitch`. Then each thread takes
runs of 8 outputs and reads every tap at a plain offset into the window:
gaussian3, sharpen, edge and the median two pixels a 32-bit word in 16-bit
lanes, all but sharpen walking down a band of rows with the three rows'
column pairs in rotating registers; the wider gaussians separable; erode and
dilate by column extrema; the point stages four bytes a word; rank and
kernel stages one pixel a thread. Here each step runs in torch over every
tile of seeded random planes, with the kernels' thread map, and must give
:mod:`hipe_tpu_torch.ops.blur`'s integers over every width, tile and mode,
and hipe_tpu's (its tiled Pallas kernels in interpret mode, its XLA stages
on the CPU) for every stage, bit for bit.

The registries are process-global in both packages, so every stage
registered here carries a ``torchport_`` name no other test file uses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import blur as jblur
from hipe_tpu.ops import pallas_blur
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import planar

RUN = planar.RUN
THREADS = 256  # a block's threads (kThreads)
LUT_NAME = "torchport_tiled_forms_dim"
RANK_NAME = "torchport_tiled_forms_q"
KERNEL_NAME = "torchport_tiled_forms_tilt"
for _pkg in (jblur, tblur):
    _pkg.register_lut_filter(LUT_NAME, jblur.brightness_lut(0.7))
    _pkg.register_rank_filter(RANK_NAME, 5, 6)
    _pkg.register_kernel_filter(KERNEL_NAME, range(-12, 13), 7, 2.5)

K5_STAGES = ["sharpen", "edge", "invert", "solarize", "posterize4", LUT_NAME, "median",
             "erode", "dilate", "median5", RANK_NAME, "median7", "median9", "pil_emboss",
             "pil_smooth_more", KERNEL_NAME]
STAGES = [*tblur.GAUSSIANS, *K5_STAGES]
PAIR_STAGES = ("gaussian3", "sharpen", "edge", "median")  # 16-bit lanes
WALK_STAGES = ("gaussian3", "edge", "median")  # sharpen goes a run at a time
WIDTHS = [1, 2, 3, 4, 5, 7, 255, 257, 4001]
M32 = 0xFFFFFFFF
LANES = 0x10001


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these many small tensors: on a machine that
    other test workers keep busy, a thread pool's wake-ups cost more than
    the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


def _plain(x: np.ndarray, name: str, h_pad: bool) -> np.ndarray:
    """The port's plain stage (held against hipe_tpu's by the other test files)."""
    return tblur.FILTERS[name](torch.from_numpy(x), h_axis=-2, w_axis=-1, h_pad=h_pad).numpy()


def _want(x: np.ndarray, name: str, h_pad: bool) -> np.ndarray:
    """hipe_tpu's stage (JAX, CPU) and the port's plain stage, which must agree."""
    want = np.asarray(jblur.FILTERS[name](jnp.asarray(x), h_axis=-2, w_axis=-1, h_pad=h_pad))
    np.testing.assert_array_equal(_plain(x, name, h_pad), want)
    return want


# --- The window -------------------------------------------------------------


def first_column(x0: int) -> int:
    """c0: the window's first plane column, x0 - 4 rounded down to 16."""
    return (x0 - 4) & ~15


def window(plane: torch.Tensor, r: int, y0: int, rows: int, x0: int, tw: int):
    """(rows + 2r, pitch) int64 window of the tile at (y0, x0), and c0: every
    row a plane row clamped into the plane, every column a plane column
    clamped into it, so the pads are copies of the edge rows and columns."""
    h, w = plane.shape
    c0 = first_column(x0)
    ys = torch.arange(y0 - r, y0 + rows + r).clamp(0, h - 1)
    cs = torch.arange(c0, c0 + planar.window_pitch(tw)).clamp(0, w - 1)
    return plane[ys][:, cs].to(torch.int64), c0


def thread_map(units: int, rows: int):
    """The kernels' (Map, band) layout: {thread: (run indices, rows [a, b))}
    for a tile of ``units`` runs a row and ``rows`` rows."""
    cols = min(units, THREADS)
    rows_m = THREADS // cols
    band = -(-rows // rows_m)
    out = {}
    for t in range(cols * rows_m):
        ty, tx = divmod(t, cols)
        a, b = ty * band, min(ty * band + band, rows)
        out[t] = (list(range(tx, units, cols)), (a, b))
    return out


def walk(ya: int, yb: int):
    """The output rows [ya, yb) of ``Window::walk`` and, for each, the rows its
    three rotating column-pair arrays hold (above, at, below), as the loop
    loads them."""
    if ya >= yb:
        return []
    slots = [ya - 1, ya, None]
    steps = []
    y = ya
    while True:
        for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            slots[c] = y + 1
            steps.append((y, (slots[a], slots[b], slots[c])))
            if y + 1 >= yb:
                return steps
            y += 1


# --- The forms over a window --------------------------------------------------


def _pairs(v: torch.Tensor) -> torch.Tensor:
    """Column pairs (i, i + 2) of window rows, low lane column i."""
    return (v[..., :-2] + (v[..., 2:] << 16)) & M32


def _lanewise(f, *pairs):
    ref = next(q for q in pairs if isinstance(q, torch.Tensor))
    pairs = [q if isinstance(q, torch.Tensor) else torch.full_like(ref, q) for q in pairs]
    return f(*(q & 0xFFFF for q in pairs)) + (f(*((q >> 16) & 0xFFFF for q in pairs)) << 16)


def _pmin3(a, b, c):
    return _lanewise(lambda x, y, z: torch.minimum(torch.minimum(x, y), z), a, b, c)


def _pmax3(a, b, c):
    return _lanewise(lambda x, y, z: torch.maximum(torch.maximum(x, y), z), a, b, c)


def _pmid3(a, b, c):
    return (a + b + c - _pmin3(a, b, c) - _pmax3(a, b, c)) & M32


def _pabsdiff(a, b):
    return _pmax3(a, b, b) - _pmin3(a, b, b)


def _three(v):
    return v[..., :-2], v[..., 1:-1], v[..., 2:]


def pair_stage(name: str, t, m, b) -> torch.Tensor:
    """tiled_lanes.cuh's pair form over the column pairs of the rows above,
    at and below: output pair (o, o + 2) from pairs o - 1, o, o + 1, for
    every window column o that has both neighbours."""
    if name == "gaussian3":
        v = (t + 2 * m + b) & M32  # lanes <= 1020
        v0, v1, v2 = _three(v)
        return ((v0 + 2 * v1 + v2) & M32) >> 4  # lanes <= 4080
    if name == "sharpen":
        bias = 1020 * LANES
        m0, m1, m2 = _three(m)
        v = (5 * m1 + bias - t[..., 1:-1] - b[..., 1:-1] - m0 - m2) & M32
        assert int((v & 0xFFFF).max()) <= 2295 and int((v >> 16).max()) <= 2295
        return _pmin3(_pmax3(v, bias, bias), bias + 255 * LANES, bias + 255 * LANES) - bias
    if name == "edge":
        c0, _, c2 = _three((t + 2 * m + b) & M32)
        gx = _pabsdiff(c2, c0)
        rb, rt = ((r[..., :-2] + 2 * r[..., 1:-1] + r[..., 2:]) & M32 for r in (b, t))
        return _pmin3(gx + _pabsdiff(rb, rt), 255 * LANES, 255 * LANES)
    lo, hi = _pmin3(t, m, b), _pmax3(t, m, b)
    mi = (t + m + b - lo - hi) & M32
    return _pmid3(_pmax3(*_three(lo)), _pmid3(*_three(mi)), _pmin3(*_three(hi)))


def unpair(out: torch.Tensor, cols: torch.Tensor, run_x: torch.Tensor) -> torch.Tensor:
    """The window columns ``cols`` of a run's output pairs, as
    ``pack_pairs`` takes them: column x + o (o = 0, 1, 4, 5) from the low
    lane of the pair at o, column x + o + 2 from its high lane; ``out``
    indexed by window column - 1, ``run_x`` each column's run start."""
    o = cols - run_x
    low = (o % 4) < 2
    src = torch.where(low, cols, cols - 2) - 1
    lane = torch.where(low, out[..., src] & 0xFF, (out[..., src] >> 16) & 0xFF)
    return lane


def separable_gaussian(win: torch.Tensor, r: int) -> torch.Tensor:
    taps, _ = tblur.binomial_taps(r)
    rows = win.shape[0] - 2 * r
    cols = sum(t * win[dy:dy + rows] for dy, t in enumerate(taps))  # column sums
    width = win.shape[1] - 2 * r
    acc = sum(t * cols[:, dx:dx + width] for dx, t in enumerate(taps))
    assert int(acc.max()) <= 255 << (4 * r)  # exact in int32
    return acc >> (4 * r)


def extreme(win: torch.Tensor, kmax: bool) -> torch.Tensor:
    f = torch.maximum if kmax else torch.minimum
    col = f(f(win[:-2], win[1:-1]), win[2:])  # per column, then across three
    a, b, c = _three(col)
    return f(f(a, b), c)


def point_words(win: torch.Tensor, name: str) -> torch.Tensor:
    """Four bytes a 32-bit word, as the point stages run (window rows hold
    whole words: pitch and c0 are multiples of 16)."""
    b = win.to(torch.uint8).contiguous()
    v = b.view(torch.int32).to(torch.int64) & M32
    if name == "invert":
        v = ~v
    elif name == "solarize":
        v = v ^ (((v >> 7) & 0x01010101) * 0xFF)
    else:
        v = v & (tblur.posterize_mask(int(name[len("posterize"):])) * 0x01010101)
    v = v & M32
    v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return v.view(torch.uint8).reshape(win.shape).to(torch.int64)


def per_pixel(win: torch.Tensor, name: str) -> torch.Tensor:
    """rank_stages.cuh's functors at every output of the window: the
    bit-serial rank count, or the kernel stage's exact floor division."""
    if name in tblur.RANK_STAGES:
        size, rank = tblur.RANK_STAGES[name]
    else:
        spec = tblur.KERNEL_STAGES[name]
        size = spec["size"]
    rows, width = win.shape[0] - size + 1, win.shape[1] - size + 1
    # taps[y, x, dy * size + dx]: the window around each output, row-major.
    taps = win.unfold(0, size, 1).unfold(1, size, 1).reshape(rows, width, size * size)
    if name in tblur.RANK_STAGES:
        acc = torch.zeros((rows, width), dtype=torch.int64)
        for bit in range(7, -1, -1):
            cand = acc | (1 << bit)
            below = (taps < cand[..., None]).sum(-1)
            acc = torch.where(below <= rank, cand, acc)
        return acc
    flat = torch.tensor([t for row in spec["flipped"] for t in row], dtype=torch.int64)
    num = 2 * (taps * flat).sum(-1) + spec["scale"] * (spec["off2"] + 1)
    return torch.div(num, 2 * spec["scale"], rounding_mode="floor").clamp(0, 255)


def tile_values(name: str, win: torch.Tensor, r: int, rows: int, xs: int, cols: int,
                runs: dict) -> torch.Tensor:
    """The stage's (rows, cols) outputs of the tile whose first output column
    is window column ``xs``, each read as its form reads it; ``runs`` is the
    thread map, whose walks give the pair stages' rows."""
    if name in PAIR_STAGES:
        pairs = _pairs(win)  # pairs[i, c]: window row i, columns (c, c + 2)
        out = torch.full((rows, cols), -1, dtype=torch.int64)
        colsx = torch.arange(xs, xs + cols)
        run_x = xs + (colsx - xs) // RUN * RUN
        bands = {}
        for units, band in runs.values():
            bands.setdefault(band, []).extend(units)
        # Every step of every band's walk at once: its output row, the three
        # rows its arrays hold (output row y is window row y + 1), and the
        # band's columns. The bands split the rows, so each row is one step.
        ys, trios, masks = [], [], []
        for (a, b), units in bands.items():
            steps = (walk(a, b) if name in WALK_STAGES else
                     [(y, (y - 1, y, y + 1)) for y in range(a, b)])
            mine = torch.zeros(cols, dtype=torch.bool)
            for u in units:
                mine[u * RUN:(u + 1) * RUN] = True
            for y, trio in steps:
                ys.append(y)
                trios.append(trio)
                masks.append(mine)
        trio = torch.tensor(trios) + 1
        res = pair_stage(name, pairs[trio[:, 0]], pairs[trio[:, 1]], pairs[trio[:, 2]])
        vals = unpair(res, colsx, run_x)
        out[ys] = torch.where(torch.stack(masks), vals, out[ys])
        return out
    if name in tblur.GAUSSIANS:
        full = separable_gaussian(win, r)
    elif name in ("erode", "dilate"):
        full = extreme(win, name == "dilate")
    elif name in tblur.LUT_STAGES:
        return torch.from_numpy(tblur.LUT_STAGES[name].astype(np.int64))[
            win[:, xs:xs + cols]]
    elif r == 0:
        return point_words(win, name)[:, xs:xs + cols]
    else:
        full = per_pixel(win, name)
    return full[:, xs - r:xs - r + cols]


def tiled_forms(x: np.ndarray, name: str, tile: tuple, h_pad: bool) -> np.ndarray:
    """The stage over (N, H, W) planes, tile by tile, each from its window."""
    n, h, w = x.shape
    r = tblur.FILTER_RADIUS[name]
    ho = h if h_pad else h - 2 * r
    out_off = (h - ho) // 2
    th, tw = tile
    twr = -(-tw // RUN) * RUN
    pitch = planar.window_pitch(tw)
    out = torch.full((n, ho, w), -1, dtype=torch.int64)
    planes = torch.from_numpy(x)
    for p in range(n):
        for y0 in range(out_off, out_off + ho, th):
            rows = min(th, ho + out_off - y0)
            for x0 in range(0, w, twr):
                cols = min(twr, w - x0)
                win, c0 = window(planes[p], r, y0, rows, x0, tw)
                # Every tap a run reads lies in the window: columns x - 4 ..
                # x + 11 of each run x, rows y0 - r .. y0 + rows + r - 1.
                assert c0 % 16 == 0 and c0 <= x0 - 4
                assert x0 + -(-cols // RUN) * RUN + 4 <= c0 + pitch
                units = -(-cols // RUN)
                runs = thread_map(units, rows)
                vals = tile_values(name, win, r, rows, x0 - c0, cols, runs)
                dst = out[p, y0 - out_off:y0 - out_off + rows, x0:x0 + cols]
                assert bool((dst == -1).all()), "a pixel is written twice"
                dst.copy_(vals)
    assert bool((out >= 0).all()), "a pixel is never written"
    return out.to(torch.uint8).numpy()


def _tiles(w: int) -> list:
    """Odd tiles, tiles smaller than a run, square ones, a full-width strip
    and tiles wider than the plane; fewer and wider on wide planes."""
    if w > 300:
        return [(16, 512), (6, w)]
    if w > 7:
        return [(5, 37), (13, 64), (8, w)]
    return [(5, 7), (3, 5), (4, 4), (16, 512), (8, w), (13, 4096)]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("name", STAGES)
def test_tiled_window_forms_match_plain(name, w):
    x = _planes(2 if w < 8 else 1, 13, w, seed=w + len(name))
    r = tblur.FILTER_RADIUS[name]
    for h_pad in (True, False):
        if not h_pad and x.shape[1] <= 2 * r:
            continue
        want = _plain(x, name, h_pad)
        for tile in _tiles(w):
            np.testing.assert_array_equal(tiled_forms(x, name, tile, h_pad), want,
                                          err_msg=f"tile={tile} h_pad={h_pad}")


@pytest.mark.parametrize("name", STAGES)
def test_tiled_window_forms_match_tiled_pallas(name):
    """Against hipe_tpu's tiled kernels (e) and (f) in interpret mode, on
    planes whose rows are not a multiple of the Pallas tile, and against
    its XLA stage in valid mode."""
    x = _planes(1, 20, 41, seed=len(name))
    np.testing.assert_array_equal(tiled_forms(x, name, (5, 7), False), _want(x, name, False))
    if name in tblur.GAUSSIANS:
        want = pallas_blur.gaussian_blur_planar_tiled_pallas(
            jnp.asarray(x), tblur.FILTER_RADIUS[name], tile_h=8, interpret=True)
    else:
        want = pallas_blur.filter_chain_planar_tiled_pallas(jnp.asarray(x), (name,), tile_h=8,
                                                            interpret=True)
    for tile in ((5, 7), (8, 16), (20, 41)):
        np.testing.assert_array_equal(tiled_forms(x, name, tile, True), np.asarray(want),
                                      err_msg=f"tile={tile}")


def test_extreme_planes_through_the_lane_forms():
    """Planes of 0 and 255 only, the ends of every lane's range."""
    x = np.random.default_rng(5).choice(np.array([0, 255], dtype=np.uint8), size=(2, 11, 37))
    for name in PAIR_STAGES:
        for tile in ((4, 4), (11, 40)):
            np.testing.assert_array_equal(tiled_forms(x, name, tile, True), _plain(x, name, True))


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 16, 32])
def test_walk_rotates_the_three_rows(rows):
    """Window::walk's three arrays take turns as above, at and below; each
    step loads one row, and a band of any length ends where it should."""
    for ya in (0, 5):
        steps = walk(ya, ya + rows)
        assert [y for y, _ in steps] == list(range(ya, ya + rows))
        assert all(trio == (y - 1, y, y + 1) for y, trio in steps)
    assert walk(3, 3) == []


@pytest.mark.parametrize("units,rows", [(1, 1), (1, 13), (2, 5), (16, 8), (64, 16), (63, 7),
                                        (256, 3), (500, 32), (501, 2)])
def test_thread_map_takes_every_output_once(units, rows):
    seen = np.zeros((rows, units), dtype=int)
    for runs, (a, b) in thread_map(units, rows).values():
        for u in runs:
            seen[a:b, u] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("tw", [1, 4, 7, 8, 9, 15, 16, 17, 24, 100, 128, 256, 500, 512,
                                1000, 4000, 4001, 4096])
def test_window_pitch_is_the_widest_window_of_a_launch(tw):
    """window_pitch is what the tiles of a launch need at most: from x0 - 4
    rounded down to 16 to x0 + TW + 4 rounded up to 16, x0 = k * TW rounded
    to a run; a multiple of 16, so 16-byte chunks of a plane row whose w is
    a multiple of 16 lie wholly inside the row or wholly in a pad."""
    twr = -(-tw // RUN) * RUN
    pitch = planar.window_pitch(tw)
    need = max((-(-(x0 + twr + 4) // 16) * 16) - first_column(x0)
               for x0 in range(0, 4 * twr, twr))
    assert pitch == need and pitch % 16 == 0
    for w in (16, 4000):
        for x0 in range(0, 4 * twr, twr):
            for c in range(first_column(x0), first_column(x0) + pitch, 16):
                assert c + 16 <= 0 or c >= w or (0 <= c and c + 16 <= w)


@pytest.mark.parametrize("name", ["gaussian3", "gaussian9", "sharpen", "invert", "median9"])
def test_shared_bytes_is_the_window(name):
    r = tblur.FILTER_RADIUS[name]
    plane = torch.zeros((40, 600), dtype=torch.uint8)
    for tile in ((16, 512), (5, 7), (32, 4000), (64, 128)):
        win, _ = window(plane, r, 0, tile[0], 0, tile[1])
        assert planar.tiled_shared_bytes(name, tile) == win.numel()
    # The autotune skips what shared memory cannot hold (232,448 bytes).
    assert planar.tiled_shared_bytes(name, (64, 4000)) == (64 + 2 * r) * 4032
