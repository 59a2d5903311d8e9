"""The register forms of K2's and K3's stages, restated in plain PyTorch over
whole planes, against hipe_tpu's stages and the port's plain ones, exactly.

``hipe_tpu_torch/csrc/chain_lanes.cuh`` computes each stage of a chain in a
form other than the definition: the gaussian separable (column sums, then
row sums, then ``>> 4r``), Sobel from per-column sums and differences, the
3x3 median from per-column sorts (``mid = a + b + c - lo - hi``), erode and
dilate from per-column extrema, the point stages four bytes at a time in a
32-bit word, gaussian3, sharpen, edge and the median two pixels a word in
16-bit lanes (a bias keeps sharpen's lanes non-negative, so they stay
apart), and a stage's clamp as pads that the stage before it writes
(its run at column 0 fills the left pad; its last run masks the columns past
``w - 1`` and fills the right pad). Here each form runs over whole planes
with the pads made by clamping indices, and must give hipe_tpu's integers
(JAX on the CPU) and :mod:`hipe_tpu_torch.ops.blur`'s, bit for bit, on seeded
random planes and on planes of 0 and 255 only. The shared-memory layout that
``models/pipelines.py`` describes to the router is checked here too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.ops import blur as jblur
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops import blur as tblur
from hipe_tpu_torch.ops import planar

RUN = planar.RUN  # output bytes a thread computes at once
INPUTS = {
    "random": lambda: np.random.default_rng(11).integers(0, 256, (3, 17, 24), dtype=np.uint8),
    "random_wide": lambda: np.random.default_rng(12).integers(0, 256, (2, 9, 40), dtype=np.uint8),
    "extremes": lambda: np.random.default_rng(13).choice(
        np.array([0, 255], dtype=np.uint8), size=(2, 11, 12)),
}


def _want(x: np.ndarray, name: str) -> np.ndarray:
    """hipe_tpu's stage (JAX, CPU) and the port's plain stage, which must agree."""
    want = np.asarray(jblur.FILTERS[name](jnp.asarray(x), h_axis=-2, w_axis=-1))
    plain = tblur.FILTERS[name](torch.from_numpy(x), h_axis=-2, w_axis=-1).numpy()
    np.testing.assert_array_equal(plain, want)
    return want


def _padded(x: np.ndarray, r: int) -> torch.Tensor:
    """(N, H + 2r, W + 2r) int32: the plane with r rows and columns of pads,
    copies of its edge, as the stage before writes them."""
    t = torch.from_numpy(x).to(torch.int32)
    h, w = t.shape[-2:]
    rows = torch.arange(-r, h + r).clamp(0, h - 1)
    cols = torch.arange(-r, w + r).clamp(0, w - 1)
    return t[:, rows][:, :, cols]


def _rows3(x: np.ndarray):
    """The rows above, at and below every output row, each W + 2 wide."""
    p = _padded(x, 1)
    return p[:, :-2], p[:, 1:-1], p[:, 2:]


def _three(v: torch.Tensor):
    """Columns x - 1, x and x + 1 of per-column values W + 2 wide."""
    return v[..., :-2], v[..., 1:-1], v[..., 2:]


def _mid3(a, b, c):
    return torch.maximum(torch.minimum(a, b), torch.minimum(torch.maximum(a, b), c))


def gaussian_form(x: np.ndarray, r: int) -> np.ndarray:
    taps, _ = tblur.binomial_taps(r)
    p = _padded(x, r)
    h, w = x.shape[-2:]
    cols = sum(t * p[:, dy:dy + h] for dy, t in enumerate(taps))  # column sums
    acc = sum(t * cols[..., dx:dx + w] for dx, t in enumerate(taps))  # row sums
    assert int(acc.max()) <= 255 << (4 * r)  # exact in int32
    return (acc >> (4 * r)).to(torch.uint8).numpy()


def sharpen_form(x: np.ndarray) -> np.ndarray:
    t, m, b = _rows3(x)
    left, c, right = _three(m)
    v = 5 * c - t[..., 1:-1] - b[..., 1:-1] - left - right
    return v.clamp(0, 255).to(torch.uint8).numpy()


def edge_form(x: np.ndarray) -> np.ndarray:
    t, m, b = _rows3(x)
    sums = t + 2 * m + b  # per column, shared by three outputs
    diffs = b - t
    sl, _, sr = _three(sums)
    dl, dc, dr = _three(diffs)
    gx = sr - sl
    gy = dl + 2 * dc + dr
    return (gx.abs() + gy.abs()).clamp(max=255).to(torch.uint8).numpy()


def median_form(x: np.ndarray) -> np.ndarray:
    t, m, b = _rows3(x)
    lo = torch.minimum(torch.minimum(t, m), b)  # each column sorted once
    hi = torch.maximum(torch.maximum(t, m), b)
    mid = t + m + b - lo - hi
    l0, l1, l2 = _three(lo)
    m0, m1, m2 = _three(mid)
    h0, h1, h2 = _three(hi)
    out = _mid3(torch.maximum(torch.maximum(l0, l1), l2), _mid3(m0, m1, m2),
                torch.minimum(torch.minimum(h0, h1), h2))
    return out.to(torch.uint8).numpy()


def extreme_form(x: np.ndarray, kmax: bool) -> np.ndarray:
    f = torch.maximum if kmax else torch.minimum
    t, m, b = _rows3(x)
    col = f(f(t, m), b)  # per column, then across three columns
    c0, c1, c2 = _three(col)
    return f(f(c0, c1), c2).to(torch.uint8).numpy()


def _words(x: np.ndarray) -> torch.Tensor:
    """The plane as 32-bit words, four bytes each, as the kernels load a run."""
    assert x.shape[-1] % 4 == 0
    return torch.from_numpy(x.copy()).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bytes(words: torch.Tensor, shape) -> np.ndarray:
    w = words & 0xFFFFFFFF
    w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return w.view(torch.uint8).reshape(shape).numpy()


def point_form(x: np.ndarray, name: str) -> np.ndarray:
    v = _words(x)
    if name == "invert":
        out = ~v
    elif name == "solarize":  # x ^ 0xFF where bit 7 is set
        out = v ^ (((v >> 7) & 0x01010101) * 0xFF)
    else:
        out = v & (tblur.posterize_mask(int(name[len("posterize"):])) * 0x01010101)
    return _bytes(out, x.shape)


# --- Two pixels a 32-bit word, in 16-bit lanes (gaussian3, sharpen, edge,
# median): pair (a, b) = column a + column b << 16, as uint32 in int64.
M32 = 0xFFFFFFFF
LANES = 0x10001


def _pk(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (lo.to(torch.int64) + (hi.to(torch.int64) << 16)) & M32


def _lanewise(f, *pairs):
    ref = next(q for q in pairs if isinstance(q, torch.Tensor))
    pairs = [q if isinstance(q, torch.Tensor) else torch.full_like(ref, q) for q in pairs]
    lo = f(*(q & 0xFFFF for q in pairs))
    hi = f(*((q >> 16) & 0xFFFF for q in pairs))
    return lo + (hi << 16)


def _pmin3(a, b, c):
    return _lanewise(lambda x, y, z: torch.minimum(torch.minimum(x, y), z), a, b, c)


def _pmax3(a, b, c):
    return _lanewise(lambda x, y, z: torch.maximum(torch.maximum(x, y), z), a, b, c)


def _pmid3(a, b, c):
    return (a + b + c - _pmin3(a, b, c) - _pmax3(a, b, c)) & M32


def _pairs(v: torch.Tensor) -> torch.Tensor:
    """Pairs (i, i + 2) of per-column values v[..., i], for i = 0 .. W - 1."""
    return _pk(v[..., :-2], v[..., 2:])


def _unpair(out: torch.Tensor, w: int) -> tuple:
    """Output pairs (o, o + 2), o = 0 .. W - 3, read as the kernels read
    them (bytes 0 and 2 of the word): columns 0 .. W - 3 from the low lanes
    and 2 .. W - 1 from the high lanes, each as uint8."""
    return ((out & 0xFF).to(torch.uint8).numpy(),
            ((out >> 16) & 0xFF).to(torch.uint8).numpy())


def _pair_rows(x: np.ndarray):
    """Pairs (i, i + 2) of the rows above, at and below: columns i - 1, i + 1."""
    return tuple(_pairs(r.to(torch.int64)) for r in _rows3(x))


def gaussian3_pair_form(x: np.ndarray) -> np.ndarray:
    t, m, b = _pair_rows(x)
    v = (t + 2 * m + b) & M32  # lanes <= 1020
    acc = (v[..., :-2] + 2 * v[..., 1:-1] + v[..., 2:]) & M32  # lanes <= 4080
    return _unpair(acc >> 4, x.shape[-1])  # byte 0 takes no bit of lane 1


def sharpen_pair_form(x: np.ndarray) -> np.ndarray:
    bias = 1020 * LANES
    t, m, b = _pair_rows(x)
    v = (5 * m[..., 1:-1] + bias - t[..., 1:-1] - b[..., 1:-1] - m[..., :-2] - m[..., 2:]) & M32
    assert int((v & 0xFFFF).max()) <= 2295 and int((v >> 16).max()) <= 2295
    v = _pmin3(_pmax3(v, bias, bias), bias + 255 * LANES, bias + 255 * LANES) - bias
    return _unpair(v, x.shape[-1])


def edge_pair_form(x: np.ndarray) -> np.ndarray:
    t, m, b = _pair_rows(x)
    cs = (t + 2 * m + b) & M32

    def absdiff(p, q):
        return _pmax3(p, q, q) - _pmin3(p, q, q)

    gx = absdiff(cs[..., 2:], cs[..., :-2])
    rows = [(r[..., :-2] + 2 * r[..., 1:-1] + r[..., 2:]) & M32 for r in (b, t)]
    gy = absdiff(*rows)
    return _unpair(_pmin3(gx + gy, 255 * LANES, 255 * LANES), x.shape[-1])


def median_pair_form(x: np.ndarray) -> np.ndarray:
    t, m, b = _pair_rows(x)
    lo, hi = _pmin3(t, m, b), _pmax3(t, m, b)
    mi = (t + m + b - lo - hi) & M32
    l0, l1, l2 = _three(lo)
    m0, m1, m2 = _three(mi)
    h0, h1, h2 = _three(hi)
    return _unpair(_pmid3(_pmax3(l0, l1, l2), _pmid3(m0, m1, m2), _pmin3(h0, h1, h2)),
                   x.shape[-1])


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("name,form", [
    ("gaussian3", gaussian3_pair_form),
    ("sharpen", sharpen_pair_form),
    ("edge", edge_pair_form),
    ("median", median_pair_form),
])
def test_16_bit_lane_forms(name, form, inputs):
    x = INPUTS[inputs]()
    want = _want(x, name)
    low, high = form(x)
    np.testing.assert_array_equal(low, want[..., :-2])
    np.testing.assert_array_equal(high, want[..., 2:])


def _byte_perm(x: int, y: int, sel: int) -> int:
    v = (y << 32) | x
    return sum(((v >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def test_byte_permutes_take_the_column_pairs_a_run_needs():
    """``col_pairs``, ``own_pairs`` and ``pack_pairs`` of chain_lanes.cuh,
    restated: the words around a run give pairs (c, c + 2) for c = -1 .. 6,
    and output pairs (0, 2), (1, 3), (4, 6), (5, 7) pack back to the run."""
    assert RUN == 8
    row = np.random.default_rng(3).integers(0, 256, 16, dtype=np.uint8)  # columns -4 .. 11
    wd = [int(v) for v in row.view("<u4")]
    o0 = _byte_perm(wd[0], 0, 0x4341)
    e1, o1 = _byte_perm(wd[1], 0, 0x4240), _byte_perm(wd[1], 0, 0x4341)
    e2, o2 = _byte_perm(wd[2], 0, 0x4240), _byte_perm(wd[2], 0, 0x4341)
    e3 = _byte_perm(wd[3], 0, 0x4240)
    pairs = [_byte_perm(o0, o1, 0x5432), e1, o1, _byte_perm(e1, e2, 0x5432),
             _byte_perm(o1, o2, 0x5432), e2, o2, _byte_perm(e2, e3, 0x5432)]
    col = {c: int(row[c + 4]) for c in range(-4, 12)}
    for i, c in enumerate(range(-1, 7)):
        assert pairs[i] == col[c] + (col[c + 2] << 16), c
    # Output pair k reads pairs b, b + 1, b + 2 (b = k + (k & 2)), centred on
    # its own columns.
    for k, o in enumerate((0, 1, 4, 5)):
        assert pairs[k + (k & 2) + 1] == col[o] + (col[o + 2] << 16)
    own = [_byte_perm(wd[1], 0, 0x4240), _byte_perm(wd[1], 0, 0x4341),
           _byte_perm(wd[2], 0, 0x4240), _byte_perm(wd[2], 0, 0x4341)]
    assert own == [pairs[k + (k & 2) + 1] for k in range(4)]
    # Lanes with garbage above their low byte: only bytes 0 and 2 are read.
    outs = [p | 0x7F007F00 for p in own]
    packed = [_byte_perm(outs[0], outs[1], 0x6240), _byte_perm(outs[2], outs[3], 0x6240)]
    assert packed == wd[1:3]


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_separable_gaussian_form(r, inputs):
    x = INPUTS[inputs]()
    np.testing.assert_array_equal(gaussian_form(x, r), _want(x, f"gaussian{2 * r + 1}"))


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("name,form", [
    ("sharpen", sharpen_form),
    ("edge", edge_form),
    ("median", median_form),
    ("erode", lambda x: extreme_form(x, False)),
    ("dilate", lambda x: extreme_form(x, True)),
])
def test_3x3_register_forms(name, form, inputs):
    x = INPUTS[inputs]()
    np.testing.assert_array_equal(form(x), _want(x, name))


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("name", ["invert", "solarize",
                                  *(f"posterize{b}" for b in range(1, 9))])
def test_point_stages_four_bytes_a_word(name, inputs):
    x = INPUTS[inputs]()
    np.testing.assert_array_equal(point_form(x, name), _want(x, name))


def test_every_byte_through_the_word_forms():
    x = np.arange(256, dtype=np.uint8).reshape(1, 4, 64)
    for name in ("invert", "solarize", *(f"posterize{b}" for b in range(1, 9))):
        np.testing.assert_array_equal(point_form(x, name), _want(x, name))


def _stored_row(row: np.ndarray, garbage: int) -> np.ndarray:
    """Columns -4 .. round_up(w, RUN) + 3 of a buffer row as a stage stores
    ``row``: run by run, the last run's columns past w - 1 masked to column
    w - 1 (``RunEdge`` and ``SharedSink::put``), the left pad from the run
    at column 0 and the right pad from the last run."""
    w = row.size
    end = -(-w // RUN) * RUN
    buf = np.full(end + 8, garbage, dtype=np.uint8)  # buf[c + 4] is column c
    for x in range(0, w, RUN):
        run = np.full(RUN, garbage, dtype=np.uint8)
        run[:min(RUN, w - x)] = row[x:x + RUN]
        keep = w - x
        words = run.view("<u4").copy()
        if keep <= RUN:
            fill = int(run[keep - 1]) * 0x01010101
            for j in range(RUN // 4):
                kj = keep - 4 * j
                mask = 0xFFFFFFFF if kj >= 4 else 0 if kj <= 0 else 0xFFFFFFFF >> (8 * (4 - kj))
                words[j] = (int(words[j]) & mask) | (fill & ~mask & 0xFFFFFFFF)
            buf[x + RUN + 4:x + RUN + 8] = run[keep - 1]
        buf[x + 4:x + 4 + RUN] = words.view(np.uint8)
        if x == 0:
            buf[0:4] = words.view(np.uint8)[0]
    return buf


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 23, 24, 31, 40])
def test_pads_are_the_clamp_of_the_row(w):
    row = np.random.default_rng(w).integers(0, 256, w, dtype=np.uint8)
    end = -(-w // RUN) * RUN
    want = np.pad(row, (4, end + 4 - w), mode="edge")
    for garbage in (0, 255):
        np.testing.assert_array_equal(_stored_row(row, garbage), want)


@pytest.mark.parametrize("w", [1, 7, 8, 9, 40, 255, 256, 257, 1000, 3032, 4000])
def test_lane_pitch_holds_the_padded_row(w):
    pitch = planar.lane_pitch(w)
    need = 16 + -(-w // RUN) * RUN + 4  # lead, the runs, the right pad
    assert pitch % 16 == 0 and need <= pitch < need + 16


def test_fused_shared_bytes_describes_the_padded_layout():
    chain = ("gaussian3", "sharpen", "edge")
    assert planar.lane_pitch(256) == 288
    assert planar.fused_shared_bytes(64, 256, chain) == 2 * (64 + 6) * 288
    assert planar.fused_shared_bytes(128, 256, ("median", "gaussian3")) == 2 * 132 * 288
    # A LUT stage adds its 256-byte table once, however often it recurs.
    name = "torchport_forms_dim"
    tblur.register_lut_filter(name, tblur.brightness_lut(0.7))
    assert (planar.fused_shared_bytes(32, 256, (name, "gaussian3", name))
            == 2 * (32 + 2) * 288 + 256)
    # A single gaussian is K1's, which keeps its row sums in registers.
    assert planar.fused_shared_bytes(32, 256, ("gaussian3",)) == 0


@pytest.mark.parametrize("name", sorted(n for n, p in tplib.PIPELINES.items()
                                         if isinstance(p, tplib.Pipeline)))
def test_stream_planes_stay_fused_and_large_frames_go_tiled(name):
    pipe = tplib.PIPELINES[name]
    assert not pipe.routes_tiled(256, 256)
    # K1 has no width limit, so a single gaussian stays on it; every other
    # chain's 4000x2250 frames go tiled.
    assert pipe.routes_tiled(2250, 4000) == (not pipe.single_gaussian)
