"""The tile of K2's planar entry and K3 (``chain_lanes.cuh``'s ``Tile``),
restated in plain PyTorch with the kernels' thread map, against the port's
plain chain and hipe_tpu's, exactly.

A block owns a tile of ``rows_per_block`` output rows ``[g0, g1)`` of one
plane. It stages the plane rows ``[g0 - R, g1 + R)`` its first stage reads,
each clamped into the plane, into buffer 0: padded rows of the columns -4 ..
``round_up(w, 8) + 3``, the pads copies of columns 0 and ``w - 1``. Stage k
reads buffer ``k & 1`` over the rows ``[g0 - Q_k, g1 + Q_k)`` clipped to the
plane, ``Q_k`` the radius of the stages after it, and writes the other buffer
(``SharedSink``: each run masked past ``w - 1``, the left and right pads, and
at plane rows 0 and ``h - 1`` copies into the rows above and below that the
next stage reads) or, the last stage, the output plane. Threads are laid out
as (row, run of 8), ``Map(ceil(w / 8))``. gaussian3, sharpen, edge and the
median walk: thread row ``ty`` of ``rows`` takes the band ``[r0 + n ty / rows, r0 +
n (ty + 1) / rows)`` of the stage's ``n`` rows and walks down it
(``lanes::walk``: three column-pair arrays in rotation, one row loaded and
unpacked a step); every other stage steps down its rows by ``rows``.

Here each buffer is poisoned (-1) before a stage writes it, so a row or pad
that a stage reads and the stage before did not write shows; every walking
step must read the rows above, at and below its output row, and every output
row of a stage must come from one step. The pair forms and the walk are
``test_torch_tiled_forms``'s (K4 and K5 share them with K2 and K3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import blur as jblur
from hipe_tpu_torch.ops import blur as tblur
from test_torch_tiled_forms import _pairs, pair_stage, unpair, walk

RUN = 8
THREADS = 256  # a block's threads (kThreads)
WALKS = ("gaussian3", "sharpen", "edge", "median")  # stages whose form walks (lanes::Walks)
LUT_NAME = "torchport_chain_walk_dim"
for _pkg in (jblur, tblur):
    _pkg.register_lut_filter(LUT_NAME, jblur.brightness_lut(0.7))

CHAINS = [
    ("gaussian3", "sharpen", "edge"),
    (LUT_NAME, "edge", "invert", "gaussian3", "sharpen"),
    ("median", "gaussian3"),
    ("sharpen", "gaussian5", "edge", "posterize4"),
]
WIDTHS = [1, 2, 3, 4, 5, 7, 255, 257, 320]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these many small tensors (as the forms tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def thread_rows(w: int) -> int:
    """Map(ceil(w / 8)): rows of threads, each thread row covering every run."""
    return THREADS // min(-(-w // RUN), THREADS)


def bands(r0: int, r1: int, rows: int) -> list:
    """Each thread row's band of the stage's rows [r0, r1), split evenly."""
    n = r1 - r0
    return [(r0 + n * ty // rows, r0 + n * (ty + 1) // rows) for ty in range(rows)]


def stage_steps(name: str, r0: int, r1: int, rows: int) -> list:
    """(output row, the rows a walking step holds as above, at and below, or
    None) of every step of every thread row of a stage."""
    if name in WALKS:
        return [step for a, b in bands(r0, r1, rows) for step in walk(a, b)]
    return [(y, None) for ty in range(rows) for y in range(r0 + ty, r1, rows)]


def stage_values(name: str, buf: torch.Tensor, base: int, steps: list, w: int) -> torch.Tensor:
    """The stage's outputs at columns 0 .. round_up(w, 8) - 1 of each step's
    row, read from the buffer ``buf`` (column c at index c + 4) as the
    stage's form reads it; every buffer value read must have been written."""
    end = -(-w // RUN) * RUN
    r = tblur.FILTER_RADIUS[name]
    ys = torch.tensor([y for y, _ in steps])
    if name in WALKS:
        trio = torch.tensor([t for _, t in steps]) - base
        assert all(t == (y - 1, y, y + 1) for y, t in steps)
        rows = buf[trio]
        assert bool((rows >= 0).all()), "a walking step reads a row no stage wrote"
        pairs = _pairs(rows)
        res = pair_stage(name, pairs[:, 0], pairs[:, 1], pairs[:, 2])
        cols = torch.arange(4, 4 + end)
        return unpair(res, cols, 4 + (cols - 4) // RUN * RUN)
    lo, hi = int(ys.min()) - r, int(ys.max()) + r + 1
    win = buf[lo - base:hi - base]
    read = win if r else win[:, 4:4 + end]
    assert bool((read >= 0).all()), "a stage reads a row or pad no stage wrote"
    full = tblur.FILTERS[name](win.to(torch.uint8)[None], h_axis=-2, w_axis=-1, h_pad=False)[0]
    return full.to(torch.int64)[ys - lo - r, 4:4 + end]


def shared_sink(dst: torch.Tensor, base: int, h: int, top: int, bot: int, ys: torch.Tensor,
                vals: torch.Tensor, w: int) -> None:
    """SharedSink::put of each step's run values: columns past w - 1 and the
    right pad take column w - 1, the left pad column 0; plane rows 0 and
    h - 1 are also copied into the ``top`` rows above and ``bot`` below."""
    rows = torch.empty((len(ys), dst.shape[1]), dtype=torch.int64)
    rows[:, 4:4 + w] = vals[:, :w]
    rows[:, 4 + w:] = vals[:, w - 1:w]
    rows[:, :4] = vals[:, :1]
    for row, y in zip(rows, ys.tolist()):
        at = [y] + ([y - k for k in range(1, top + 1)] if y == 0 else []) + (
            [y + k for k in range(1, bot + 1)] if y == h - 1 else [])
        for t in at:
            assert bool((dst[t - base] == -1).all()), "a buffer row is written twice"
            dst[t - base] = row


def tile_chain(x: np.ndarray, names: tuple, h_pad: bool, rows_per_block: int,
               seen_bands: set | None = None) -> np.ndarray:
    """The chain over (N, H, W) planes, tile by tile, each through both
    buffers with the kernels' thread map (chain_planar.cu's launch and
    chain_lanes_kernel)."""
    n, h, w = x.shape
    radii = [tblur.FILTER_RADIUS[nm] for nm in names]
    after = [sum(radii[k + 1:]) for k in range(len(names))]
    total_r = sum(radii)
    ho = h if h_pad else h - 2 * total_r
    out_off = 0 if h_pad else total_r
    rpb = min(rows_per_block, ho)
    nrows = rpb + 2 * total_r
    end = -(-w // RUN) * RUN
    rows = thread_rows(w)
    out = torch.full((n, ho, w), -1, dtype=torch.int64)
    planes = torch.from_numpy(x)
    cols = torch.arange(-4, end + 4).clamp(0, w - 1)
    for p in range(n):
        for g0 in range(out_off, ho + out_off, rpb):
            g1 = min(g0 + rpb, ho + out_off)
            base = g0 - total_r
            bufs = [torch.full((nrows, end + 8), -1, dtype=torch.int64) for _ in range(2)]
            r_in = radii[0]
            lo, hi = max(base, -r_in), min(g1 + total_r, h + r_in)
            ys_in = torch.arange(lo, hi).clamp(0, h - 1)
            bufs[0][lo - base:hi - base] = planes[p][ys_in][:, cols].to(torch.int64)
            for k, name in enumerate(names):
                q = after[k]
                r0, r1 = max(g0 - q, 0), min(g1 + q, h)
                steps = stage_steps(name, r0, r1, rows)
                ys = torch.tensor([y for y, _ in steps])
                assert sorted(ys.tolist()) == list(range(r0, r1)), "rows missed or repeated"
                if seen_bands is not None and name in WALKS:
                    seen_bands.update(b - a for a, b in bands(r0, r1, rows))
                vals = stage_values(name, bufs[k & 1], base, steps, w)
                if k + 1 == len(names):
                    dst = out[p, ys - out_off]
                    assert bool((dst == -1).all()), "an output row is written twice"
                    out[p, ys - out_off] = vals[:, :w]
                    continue
                rn = q - after[k + 1]
                dst = bufs[(k & 1) ^ 1]
                dst.fill_(-1)  # what the stage before wrote there is stale
                shared_sink(dst, base, h, max(min(rn, -base), 0),
                            max(min(rn, base + nrows - h), 0), ys, vals, w)
    assert bool((out >= 0).all()), "an output pixel is never written"
    return out.to(torch.uint8).numpy()


def _planes(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


def _want(x: np.ndarray, names: tuple, h_pad: bool) -> np.ndarray:
    """The port's plain chain (held against hipe_tpu's below and by the other
    test files)."""
    return tblur.filter_chain(torch.from_numpy(x), names, h_axis=-2, w_axis=-1,
                              h_pad=h_pad).numpy()


@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_tile_walk_matches_hipe_tpu(names):
    """Against hipe_tpu's chain (JAX, CPU), clamp and valid, on a plane of
    odd width whose runs end past it."""
    x = _planes(1, 14, 37, seed=len(names))
    for h_pad in (True, False):
        want = np.asarray(jblur.filter_chain(jnp.asarray(x), names, h_axis=-2, w_axis=-1,
                                             h_pad=h_pad))
        for rpb in (1, 2, 5):
            np.testing.assert_array_equal(tile_chain(x, names, h_pad, rpb), want,
                                          err_msg=f"h_pad={h_pad} rows_per_block={rpb}")


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("names", CHAINS, ids="+".join)
def test_tile_walk_matches_plain_at_every_rows_per_block(names, w):
    """Every rows_per_block from 1 to the whole plane, clamp and valid: the
    first and last tiles replicate the plane's edge rows (clamp), the bands
    run from 0 rows to many."""
    x = _planes(2 if w < 8 else 1, 15, w, seed=w + 7 * len(names))
    for h_pad in (True, False):
        want = _want(x, names, h_pad)
        for rpb in range(1, want.shape[1] + 1):
            np.testing.assert_array_equal(tile_chain(x, names, h_pad, rpb), want,
                                          err_msg=f"h_pad={h_pad} rows_per_block={rpb}")


@pytest.mark.parametrize("h_pad", [True, False])
def test_tile_walk_on_the_benchmark_planes(h_pad):
    """A 240x320 plane, the benchmark's, at the autotune's rows_per_block and
    the whole plane; the walking stages' bands there are 1 to 12 rows long,
    among them 1, 2 and 3, where the rotation stops in its first turn."""
    from hipe_tpu_torch.ops.planar import ROWS_PER_BLOCK_CANDIDATES

    names = ("gaussian3", "sharpen", "edge")
    x = _planes(1, 240, 320, seed=240)
    want = _want(x, names, h_pad)
    seen = set()
    for rpb in sorted({*ROWS_PER_BLOCK_CANDIDATES, 1, 2, want.shape[1]}):
        np.testing.assert_array_equal(tile_chain(x, names, h_pad, rpb, seen), want,
                                      err_msg=f"rows_per_block={rpb}")
    assert {1, 2, 3} <= seen


def test_extreme_planes_through_the_tile():
    """Planes of 0 and 255 only, the ends of every lane's range."""
    x = np.random.default_rng(9).choice(np.array([0, 255], dtype=np.uint8), size=(2, 12, 37))
    for names in CHAINS:
        for rpb in (1, 3, 12):
            np.testing.assert_array_equal(tile_chain(x, names, True, rpb), _want(x, names, True))


@pytest.mark.parametrize("rows", [1, 6, 7, 8, 32, 256])
def test_bands_split_a_stage_evenly_and_walk_it(rows):
    """The bands of a stage's rows cover them once, differ by at most one
    row, and a walk over a band loads its rows and the two around it, each
    once (one row a step after the first two)."""
    for r0 in (0, 3):
        for n in range(0, 70):
            got = bands(r0, r0 + n, rows)
            assert [a for a, _ in got[1:]] == [b for _, b in got[:-1]]
            assert got[0][0] == r0 and got[-1][1] == r0 + n
            sizes = [b - a for a, b in got]
            assert max(sizes) - min(sizes) <= 1
            for a, b in got:
                steps = walk(a, b)
                assert [y for y, _ in steps] == list(range(a, b))
                loaded = [steps[0][1][0], steps[0][1][1]] + [t[2] for _, t in steps] if steps else []
                assert loaded == list(range(a - 1, b + 1)) or (a == b and loaded == [])


@pytest.mark.parametrize("w,rows", [(1, 256), (7, 256), (8, 256), (9, 128), (255, 8),
                                    (257, 7), (320, 6), (2048, 1), (4000, 1)])
def test_thread_rows_of_the_run_map(w, rows):
    assert thread_rows(w) == rows
