"""The port's lossless DCT-domain transforms on the CPU, held exactly against
hipe_tpu.

Mirrors ``test_jpeg_transform.py``: every op's coefficients against an
independent straight-loop oracle through a file round trip, output bytes
equal to ``hipe_tpu``'s ``transform_bytes``/``transform_batch``/
``crop_bytes``, the jpegtran ``-perfect`` refusals, transposed quant tables,
markers copied, the crop, the grayscale drop and the ``transform`` CLI. The
coefficient ops run on CPU tensors here (``device="cpu"``); every
comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.io_ import jpeg as hjpeg
from hipe_tpu.ops import jpeg_transform as hjt
from hipe_tpu_torch import cli
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.ops import jpeg_decode as tjd
from hipe_tpu_torch.ops import jpeg_transform as tjt

CPU = "cpu"


def _stream(h, w, sub="420", quality=85, seed=0, c=3, **opts):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 1:
        return tjpeg.encode_bytes_opts(img, quality=quality, **opts)
    return tjpeg.encode_bytes_opts(img, quality=quality, subsampling=sub, **opts)


def _dims(co, comp):
    return -(-co.height * comp.v_samp // co.max_v), -(-co.width * comp.h_samp // co.max_h)


def _component_samples(data):
    """Each component's integer IDCT samples (no upsampling)."""
    co = tjpeg.read_coefficients(data)
    return [tjd.idct8x8_islow(torch.from_numpy(c.coefs), c.qtable).numpy()
            [: _dims(co, c)[0], : _dims(co, c)[1]] for c in co.components]


def _spatial(op, img):
    return {"flip_h": lambda: img[:, ::-1], "flip_v": lambda: img[::-1],
            "rot90": lambda: np.rot90(img, k=-1), "rot180": lambda: np.rot90(img, k=2),
            "rot270": lambda: np.rot90(img, k=1), "transpose": lambda: img.T,
            "transverse": lambda: np.rot90(img, 2).T}[op]()


def _coef_oracle(op, blocks):
    """Straight-loop DCT-symmetry oracle on (Hb, Wb, 8, 8)."""
    hb, wb = blocks.shape[:2]
    if op in ("flip_h", "flip_v"):
        out = np.empty_like(blocks)
        for by in range(hb):
            for bx in range(wb):
                for u in range(8):
                    for v in range(8):
                        if op == "flip_h":
                            out[by, wb - 1 - bx, u, v] = blocks[by, bx, u, v] * (-1) ** v
                        else:
                            out[hb - 1 - by, bx, u, v] = blocks[by, bx, u, v] * (-1) ** u
        return out
    if op == "transpose":
        out = np.empty((wb, hb, 8, 8), dtype=blocks.dtype)
        for by in range(hb):
            for bx in range(wb):
                out[bx, by] = blocks[by, bx].T
        return out
    steps = {"rot90": ("transpose", "flip_h"), "rot270": ("transpose", "flip_v"),
             "rot180": ("flip_h", "flip_v"), "transverse": ("transpose", "flip_h", "flip_v")}
    for step in steps[op]:
        blocks = _coef_oracle(step, blocks)
    return blocks


@pytest.mark.parametrize("op", tjt.OPS)
@pytest.mark.parametrize("sub,dims", [("420", (32, 48)), ("422", (24, 32)),
                                      ("444", (16, 24)), ("440", (32, 16))])
def test_coefficient_exact_and_bytes_equal_hipe_tpu(op, sub, dims):
    data = _stream(*dims, sub=sub, seed=3)
    out = tjt.transform_bytes(data, op, device=CPU)
    assert out == hjt.transform_bytes(data, op)
    ci = tjpeg.read_coefficients(data)
    co = tjpeg.read_coefficients(out)
    for a, b in zip(ci.components, co.components):
        hb, wb, _ = a.coefs.shape
        np.testing.assert_array_equal(b.coefs.reshape(*b.coefs.shape[:2], 8, 8),
                                      _coef_oracle(op, a.coefs.reshape(hb, wb, 8, 8)))


@pytest.mark.parametrize("op", tjt.OPS)
def test_transform_component_matches_hipe_tpu(op):
    """Batched grids over the whole int16 range (-32768 wraps when negated,
    as in hipe_tpu)."""
    coefs = np.random.default_rng(len(op)).integers(-32768, 32768, (2, 3, 5, 64)).astype(
        np.int16)
    coefs[0, 0, 0, :8] = -32768
    got = tjt.transform_component(torch.from_numpy(coefs), op).numpy()
    np.testing.assert_array_equal(got, np.asarray(hjt.transform_component(
        jnp.asarray(coefs), op)))
    with pytest.raises(ValueError, match="unknown transform"):
        tjt.transform_component(torch.from_numpy(coefs), "spin")


@pytest.mark.parametrize("op", tjt.OPS)
def test_integer_decode_within_one_of_the_spatial_transform(op):
    data = _stream(32, 48, sub="444", seed=6)
    out = tjt.transform_bytes(data, op, device=CPU)
    for b, a in zip(_component_samples(data), _component_samples(out)):
        assert np.abs(a.astype(int) - _spatial(op, b).astype(int)).max() <= 1


def test_progressive_stream_and_writer_options():
    datap = _stream(32, 48, seed=6, progressive=True)
    for opts in ({"progressive": True}, {"arithmetic": True}, {"optimize": True},
                 {"restart_interval": 2}):
        assert tjt.transform_bytes(datap, "rot90", device=CPU, **opts) == \
            hjt.transform_bytes(datap, "rot90", **opts)
    ar = tjt.transform_bytes(datap, "rot90", device=CPU, arithmetic=True)
    hu = tjt.transform_bytes(datap, "rot90", device=CPU)
    assert b"\xff\xc9" in ar
    np.testing.assert_array_equal(tjpeg.decode_bytes(ar), tjpeg.decode_bytes(hu))


def test_involutions_byte_identical():
    data = _stream(32, 48, seed=7)
    co = tjpeg.read_coefficients(data)
    canon = tjpeg.write_coefficients([c.coefs for c in co.components], 48, 32,
                                     subsampling="420",
                                     qtables=[c.qtable for c in co.components])
    assert canon == hjpeg.write_coefficients([c.coefs for c in co.components], 48, 32,
                                             subsampling="420",
                                             qtables=[c.qtable for c in co.components])
    for op in ("transpose", "flip_h"):
        assert tjt.transform_bytes(tjt.transform_bytes(data, op, device=CPU), op,
                                   device=CPU) == canon
    r = data
    for _ in range(4):
        r = tjt.transform_bytes(r, "rot90", device=CPU)
    assert r == canon


def test_perfect_rule_enforced():
    data = _stream(32, 33, seed=9)
    for op in ("flip_h", "rot180", "rot270", "transverse"):
        with pytest.raises(ValueError, match="not lossless"):
            tjt.transform_bytes(data, op, device=CPU)
    for op in ("transpose", "rot90", "flip_v"):
        assert tjt.transform_bytes(data, op, device=CPU) == hjt.transform_bytes(data, op)


def test_any_quality_tables_pass_through_transposed():
    data = _stream(16, 16, quality=73, seed=11)
    a = _component_samples(data)
    for x, y in zip(a, _component_samples(tjt.transform_bytes(data, "rot180", device=CPU))):
        np.testing.assert_array_equal(y, x[::-1, ::-1])
    co_in = tjpeg.read_coefficients(data)
    co_out = tjpeg.read_coefficients(tjt.transform_bytes(data, "transpose", device=CPU))
    for ci, co in zip(co_in.components, co_out.components):
        np.testing.assert_array_equal(co.qtable.reshape(8, 8), ci.qtable.reshape(8, 8).T)


def test_grayscale_stream():
    data = _stream(24, 40, c=1, seed=13)
    out = tjt.transform_bytes(data, "flip_v", device=CPU)
    assert out == hjt.transform_bytes(data, "flip_v")
    a = tjpeg.decode_bytes(data)[::-1].astype(int)
    assert np.abs(tjpeg.decode_bytes(out).astype(int) - a).max() <= 1


def test_transform_batch_matches_singles_and_hipe_tpu():
    rng = np.random.default_rng(17)
    ps = [tjpeg.encode_bytes_opts(rng.integers(0, 256, (32, 48, 3), np.uint8), quality=85)
          for _ in range(3)]
    ps += [tjpeg.encode_bytes_opts(rng.integers(0, 256, (16, 24, 3), np.uint8), quality=70,
                                   subsampling="444")]
    ps += [tjpeg.encode_bytes_opts(rng.integers(0, 256, (16, 24, 1), np.uint8), quality=60)]
    for op, opts in (("rot90", {}), ("flip_h", {}), ("transpose", {"optimize": True})):
        got = tjt.transform_batch(ps, op, num_threads=2, device=CPU, **opts)
        assert got == [tjt.transform_bytes(p, op, device=CPU, **opts) for p in ps]
        assert got == hjt.transform_batch(ps, op, **opts)


def test_transform_batch_rejects_imperfect_group():
    ps = [_stream(32, 33, seed=19)]
    with pytest.raises(ValueError, match="not lossless"):
        tjt.transform_batch(ps, "flip_h", device=CPU)


def test_markers_copied_through_transforms():
    img = np.random.default_rng(21).integers(0, 256, (16, 16, 3), np.uint8)
    co = tjpeg.read_coefficients(tjpeg.encode_bytes_opts(img, quality=85))
    mks = [(0xE1, b"Exif\x00\x00PAYLOAD"), (0xFE, b"hello"),
           (0xE2, b"ICC_PROFILE\x00" + bytes(32))]
    src = tjpeg.write_coefficients([c.coefs for c in co.components], 16, 16, quality=85,
                                   markers=mks)
    assert src == hjpeg.write_coefficients([c.coefs for c in co.components], 16, 16,
                                           quality=85, markers=mks)
    assert tjpeg.read_markers(src) == hjpeg.read_markers(src) == mks
    out = tjt.transform_bytes(src, "rot90", device=CPU)
    assert out == hjt.transform_bytes(src, "rot90")
    assert tjpeg.read_markers(out) == mks
    assert tjpeg.read_markers(tjt.transform_bytes(src, "rot90", copy_markers=False,
                                                  device=CPU)) == []
    plain = tjpeg.encode_bytes_opts(img, quality=85)
    batch = tjt.transform_batch([src, plain], "rot90", device=CPU)
    assert batch == [out, tjt.transform_bytes(plain, "rot90", device=CPU)]


def test_crop_lossless_and_equal_to_hipe_tpu():
    img = np.random.default_rng(23).integers(0, 256, (48, 64, 3), np.uint8)
    d444 = tjpeg.encode_bytes_opts(img, quality=85, subsampling="444")
    out = tjt.crop_bytes(d444, 16, 8, 33, 17)
    assert out == hjt.crop_bytes(d444, 16, 8, 33, 17)
    np.testing.assert_array_equal(tjpeg.decode_bytes(out), tjpeg.decode_bytes(d444)[8:25, 16:49])
    data = tjpeg.encode_bytes_opts(img, quality=85, subsampling="420")
    for region in ((16, 16, 48, 32), (16, 16, 33, 17), (0, 0, 100, 100)):
        assert tjt.crop_bytes(data, *region) == hjt.crop_bytes(data, *region)
    out = tjt.crop_bytes(data, 16, 16, 33, 17)
    ci, co = tjpeg.read_coefficients(data), tjpeg.read_coefficients(out)
    assert (co.width, co.height) == (33, 17)
    for a, b, sa, sb in zip(ci.components, co.components, _component_samples(data),
                            _component_samples(out)):
        fx, fy = a.h_samp * 16 // ci.max_h, a.v_samp * 16 // ci.max_v
        dh, dw = _dims(co, b)
        np.testing.assert_array_equal(sb, sa[fy:fy + dh, fx:fx + dw])
    with pytest.raises(ValueError, match="iMCU-aligned"):
        tjt.crop_bytes(data, 8, 0, 16, 16)
    with pytest.raises(ValueError, match="outside"):
        tjt.crop_bytes(data, 64, 0, 16, 16)
    with pytest.raises(ValueError, match="positive"):
        tjt.crop_bytes(data, 0, 0, 0, 16)
    marked = tjpeg.write_coefficients([c.coefs for c in ci.components], 64, 48, quality=85,
                                      subsampling="420", markers=[(0xFE, b"note")])
    assert tjpeg.read_markers(tjt.crop_bytes(marked, 0, 0, 32, 32)) == [(0xFE, b"note")]


def test_fill_bytes_before_marker_detected():
    img = np.random.default_rng(29).integers(0, 256, (16, 16, 3), np.uint8)
    co = tjpeg.read_coefficients(tjpeg.encode_bytes_opts(img, quality=85))
    src = tjpeg.write_coefficients([c.coefs for c in co.components], 16, 16, quality=85,
                                   markers=[(0xFE, b"m")])
    i = src.index(b"\xff\xfe")
    padded = src[:i] + b"\xff" + src[i:]
    assert tjt._has_metadata(padded) and not tjt._has_metadata(_stream(16, 16))
    out = tjt.transform_batch([padded], "rot180", device=CPU)[0]
    assert tjpeg.read_markers(out) == [(0xFE, b"m")]


def test_distinct_chroma_tables_refused():
    img = np.random.default_rng(31).integers(0, 256, (16, 16, 3), np.uint8)
    co = tjpeg.read_coefficients(tjpeg.encode_bytes_opts(img, quality=85))
    qt = [c.qtable.copy() for c in co.components]
    qt[2][0] += 1
    with pytest.raises(ValueError, match="different quant tables"):
        tjpeg.write_coefficients([c.coefs for c in co.components], 16, 16, quality=85,
                                 qtables=qt)
    stacked = [c.coefs[None] for c in co.components]
    with pytest.raises(ValueError, match="different quant tables"):
        tjpeg.write_coefficients_batch(stacked, 16, 16, qtables=qt)


@pytest.mark.parametrize("dims,sub", [((48, 64), "420"), ((41, 53), "422"),
                                      ((23, 17), "444"), ((40, 56), "440")])
def test_grayscale_drop_lossless(dims, sub):
    data = _stream(*dims, sub=sub, seed=31)
    out = tjt.transform_bytes(data, "grayscale")
    assert out == hjt.transform_bytes(data, "grayscale")
    np.testing.assert_array_equal(tjpeg.decode_bytes(out),
                                  tjpeg.decode_bytes(data, force_gray=True))
    co, ci = tjpeg.read_coefficients(out), tjpeg.read_coefficients(data)
    assert co.num_components == 1
    hb, wb = -(-dims[0] // 8), -(-dims[1] // 8)
    np.testing.assert_array_equal(co.components[0].coefs[:hb, :wb],
                                  ci.components[0].coefs[:hb, :wb])


def test_grayscale_batch_markers_and_progressive():
    img = np.random.default_rng(33).integers(0, 256, (24, 32, 3), np.uint8)
    co = tjpeg.read_coefficients(tjpeg.encode_bytes_opts(img, quality=85))
    mks = [(0xE1, b"Exif\x00\x00GRAY"), (0xFE, b"note")]
    src = tjpeg.write_coefficients([c.coefs for c in co.components], 32, 24, quality=85,
                                   markers=mks)
    assert tjpeg.read_markers(tjt.transform_bytes(src, "grayscale")) == mks
    prog = _stream(24, 32, seed=34, progressive=True)
    np.testing.assert_array_equal(tjpeg.decode_bytes(tjt.transform_bytes(prog, "grayscale")),
                                  tjpeg.decode_bytes(prog, force_gray=True))
    plain = [_stream(24, 32, seed=s) for s in (35, 36)]
    assert tjt.transform_batch(plain, "grayscale") == \
        [tjt.transform_bytes(p, "grayscale") for p in plain] == \
        hjt.transform_batch(plain, "grayscale")
    sub_luma = tjpeg.JpegCoefficients.from_arrays(
        16, 16, [np.zeros((1, 1, 64)), np.zeros((2, 2, 64)), np.zeros((2, 2, 64))],
        [np.ones(64)] * 3, [(1, 1), (2, 2), (2, 2)])
    with pytest.raises(ValueError, match="full-resolution luma"):
        tjt.transform_coefficients(sub_luma, "grayscale")


def test_transforms_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the transform would run there")
    data = _stream(16, 16, seed=37)
    with pytest.raises(RuntimeError, match="is_available"):
        tjt.transform_bytes(data, "rot90")
    with pytest.raises(RuntimeError, match="is_available"):
        tjt.transform_batch([data], "rot90")


def test_transform_cli(tmp_path, capsys):
    a, b = tmp_path / "a.jpg", tmp_path / "b.jpg"
    a.write_bytes(_stream(32, 48, seed=41))
    b.write_bytes(_stream(32, 48, seed=42))
    out = tmp_path / "out.jpg"
    assert cli.main(["transform", str(a), "rot90", "-o", str(out), "--device", CPU]) == 0
    assert out.read_bytes() == hjt.transform_bytes(a.read_bytes(), "rot90")
    assert "lossless" in capsys.readouterr().out
    assert cli.main(["transform", str(a), str(b), "transpose", "-o", str(tmp_path / "d"),
                     "--optimize", "--device", CPU]) == 0
    for p in (a, b):
        assert (tmp_path / "d" / p.name).read_bytes() == \
            hjt.transform_bytes(p.read_bytes(), "transpose", optimize=True)
    assert cli.main(["transform", str(a), "crop", "--crop", "16", "16", "20", "10", "-o",
                     str(out)]) == 0
    assert out.read_bytes() == hjt.crop_bytes(a.read_bytes(), 16, 16, 20, 10)
    capsys.readouterr()
    assert cli.main(["transform", str(a), "crop", "-o", str(out)]) == 1
    assert "requires --crop" in capsys.readouterr().out
    assert cli.main(["transform", str(tmp_path / "missing.jpg"), "rot90", "-o", str(out),
                     "--device", CPU]) == 1
    assert capsys.readouterr().out.startswith("Error:")
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "a.jpg").write_bytes(a.read_bytes())
    assert cli.main(["transform", str(a), str(tmp_path / "x" / "a.jpg"), "rot90", "-o",
                     str(tmp_path / "d2"), "--device", CPU]) == 1
    assert "collide" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert cli.main(["transform", str(a), "rot90", "-o", str(out)]) == 1
        assert "is_available" in capsys.readouterr().out
