"""The port's serving options on the CPU, held exactly against hipe_tpu.

Mirrors ``test_serve_decode_scale.py`` and ``test_colorize.py``: each of
``decode_scale``, ``decode_gray``, ``gray_output``, ``output_scale``,
``resize_to`` and ``colorize``, and their legal compositions, in all four
placements of the codec, over a colour batch (two sampling layouts, so two
device groups) and a grayscale batch; the output bytes and pixels must equal
``hipe_tpu``'s ``ServingPipeline`` (host placement, its XLA filter on the
JAX CPU backend). The grayscale batch under the default options is the
grayscale-input serving case against ``hipe_tpu``. Also: the options'
checks give ``hipe_tpu``'s errors, ``colorize_lut`` against PIL and
``hipe_tpu``, streaming, and the ``serve`` flags.
"""

import json
import sys

import numpy as np
import pytest

from hipe_tpu.io_ import jpeg as hjpeg
from hipe_tpu.ops import equalize as heq
from hipe_tpu.runtime.serve import ServingPipeline as JaxServingPipeline
from hipe_tpu_torch import cli
from hipe_tpu_torch.ops import equalize as teq
from hipe_tpu_torch.runtime.serve import ServingPipeline

CPU = "cpu"
LUT = heq.colorize_lut("blue", "yellow", mid=(120, 80, 40))


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


STREAMS = {
    "color": [hjpeg.encode_bytes_opts(_img(33, 47, seed=1), 90, "420"),
              hjpeg.encode_bytes_opts(_img(33, 47, seed=2), 90, "422"),
              hjpeg.encode_bytes_opts(_img(33, 47, seed=3), 90, "420")],
    "gray": [hjpeg.encode_bytes(_img(33, 47, 1, seed=4), 90),
             hjpeg.encode_bytes(_img(33, 47, 1, seed=5), 90)],
}

OPTIONS = {
    "default": {},
    "decode_scale=2": {"decode_scale": 2},
    "decode_scale=4": {"decode_scale": 4},
    "decode_scale=8": {"decode_scale": 8},
    "decode_gray": {"decode_gray": True},
    "gray_output": {"gray_output": True},
    "output_scale=2": {"output_scale": 2},
    "resize_to": {"resize_to": (20, 31)},
    "colorize": {"colorize": LUT},
    "decode_gray+colorize": {"decode_gray": True, "colorize": LUT},
    "gray_output+colorize": {"gray_output": True, "colorize": LUT},
    "decode_scale=2+output_scale=2+gray_output": {"decode_scale": 2, "output_scale": 2,
                                                   "gray_output": True},
    "decode_scale=4+decode_gray+resize_to": {"decode_scale": 4, "decode_gray": True,
                                             "resize_to": (9, 13)},
    "decode_scale=8+decode_gray+resize_to+colorize": {
        "decode_scale": 8, "decode_gray": True, "resize_to": (7, 5), "colorize": LUT},
}

PLACEMENTS = [(False, False), (True, False), (False, True), (True, True)]
_REFERENCE: dict = {}


def _reference(name: str, stream: str):
    """hipe_tpu's (bytes, pixels) or its ValueError, for an option and stream."""
    key = (name, stream)
    if key not in _REFERENCE:
        sp = JaxServingPipeline("blur3", use_pallas=False, **OPTIONS[name])
        try:
            _REFERENCE[key] = (sp.process_batch(STREAMS[stream]),
                               sp.process_batch(STREAMS[stream], encode=False))
        except ValueError as e:
            _REFERENCE[key] = e
        sp.close()
    return _REFERENCE[key]


@pytest.mark.parametrize("dec,enc", PLACEMENTS, ids=["host", "dec", "enc", "transcode"])
@pytest.mark.parametrize("name", OPTIONS)
def test_options_give_hipe_tpu_bytes_in_every_placement(name, dec, enc):
    for stream in STREAMS:
        want = _reference(name, stream)
        with ServingPipeline("blur3", device=CPU, decode_on_device=dec, encode_on_device=enc,
                             **OPTIONS[name]) as sp:
            if isinstance(want, ValueError):
                with pytest.raises(ValueError) as got:
                    sp.process_batch(STREAMS[stream])
                assert str(got.value) == str(want)
                continue
            assert sp.process_batch(STREAMS[stream]) == want[0], stream
            np.testing.assert_array_equal(sp.process_batch(STREAMS[stream], encode=False),
                                          want[1])


def test_colorize_on_a_colour_stage_output_is_the_one_error():
    """Of the option table, only colorize on colour stage output fails."""
    failing = {(n, s) for n in OPTIONS for s in STREAMS
               if isinstance(_reference(n, s), ValueError)}
    assert failing == {("colorize", "color")}
    assert "grayscale stage output" in str(_reference("colorize", "color"))


def test_output_dims_and_channels():
    px = ServingPipeline("blur3", device=CPU, decode_scale=2, output_scale=2,
                         decode_on_device=True).process_batch(STREAMS["color"], encode=False)
    assert px.shape == (3, 9, 12, 3)  # 33x47 -> 17x24 -> 9x12
    data = ServingPipeline("chain", device=CPU, decode_scale=4, decode_on_device=True,
                           encode_on_device=True).process_batch(STREAMS["color"])
    assert data == JaxServingPipeline("chain", use_pallas=False,
                                      decode_scale=4).process_batch(STREAMS["color"])
    assert hjpeg.decode_bytes(data[0]).shape == (9, 12, 3)
    gray = ServingPipeline("blur3", device=CPU, gray_output=True).process_batch(
        STREAMS["color"][:1])
    assert hjpeg.decode_bytes(gray[0]).shape == (33, 47, 1)


def test_decode_gray_reduces_only_full_resolution_luma():
    """decode_gray groups a full-resolution-luma stream under its luma's
    geometry and one quant table; the rest keep theirs for the host."""
    from hipe_tpu_torch.io_ import jpeg as tjpeg
    from hipe_tpu_torch.ops import jpeg_decode as tjd

    sp = ServingPipeline("blur3", device=CPU, decode_gray=True)
    cos = tjpeg.read_coefficients_batch(STREAMS["color"][:2])
    groups = sp._groups(cos)
    assert all(geo.ncomps == 1 and len(qkey) == 1 for geo, qkey in groups)
    sub_luma = tjd.DecodeGeometry(16, 16, 3, ((1, 1, 2, 2), (2, 2, 2, 2), (2, 2, 2, 2)), 2, 2)
    assert sp._maybe_gray_geo(sub_luma, ((1,), (2,), (3,))) == (sub_luma, ((1,), (2,), (3,)))
    sp.close()


@pytest.mark.parametrize("kwargs", [
    {"output_scale": 3}, {"resize_to": (0, 5)}, {"resize_to": (5.0, 5)},
    {"resize_to": (8, 8), "output_scale": 2}, {"decode_scale": 3}, {"decode_scale": 16},
    {"colorize": np.zeros((2, 256), np.uint8)},
])
def test_option_checks_match_hipe_tpu(kwargs):
    with pytest.raises(ValueError) as want:
        JaxServingPipeline("blur3", use_pallas=False, **kwargs)
    with pytest.raises(ValueError) as got:
        ServingPipeline("blur3", device=CPU, **kwargs)
    assert str(got.value) == str(want.value)


def test_odd_thumbnail_width_is_refused_by_both():
    """output_scale=2 needs an even ceil(W/2): jcsample.c's alternating bias
    is built for even widths in both packages (hipe_tpu asserts it)."""
    payloads = [hjpeg.encode_bytes(_img(16, 57, seed=6), 90)]
    with pytest.raises(AssertionError):
        JaxServingPipeline("blur3", use_pallas=False, output_scale=2).process_batch(payloads)
    with ServingPipeline("blur3", device=CPU, output_scale=2) as sp:
        with pytest.raises(ValueError, match="must be even"):
            sp.process_batch(payloads)


def test_decode_scale_streaming_run():
    payloads = STREAMS["color"] * 2
    want = JaxServingPipeline("blur3", use_pallas=False,
                              decode_scale=2).process_batch(payloads)
    with ServingPipeline("blur3", device=CPU, decode_scale=2, decode_on_device=True) as sp:
        out = [b for batch in sp.run([payloads[:3], payloads[3:]]) for b in batch]
        assert out == want and sp.stats.images == 6


def test_device_functions_are_kept_by_group_and_options():
    from hipe_tpu_torch.io_ import jpeg as tjpeg
    from hipe_tpu_torch.ops import jpeg_decode as tjd

    co = tjpeg.read_coefficients(STREAMS["color"][0])
    geo = tjd.geometry_of(co)
    qkey = tuple(tuple(int(v) for v in c.qtable) for c in co.components)
    sp = ServingPipeline("blur3", device=CPU, decode_scale=2)
    assert sp.decode_filter_fn(geo, qkey) is sp.decode_filter_fn(geo, qkey)
    assert sp.transcode_fn(geo, qkey) is not sp.decode_filter_fn(geo, qkey)
    key = next(iter(sp._fns))
    assert set(sp._options_key()) <= set(key)
    sp.close()


# ---- colorize_lut ----


@pytest.mark.parametrize("kw", [
    dict(black="blue", white="yellow"),
    dict(black=(10, 0, 30), white=(250, 240, 200), mid=(128, 20, 60)),
    dict(black="black", white="white", blackpoint=20, whitepoint=200),
    dict(black="#102030", white="#F0E0D0", mid="red", blackpoint=10, midpoint=100,
         whitepoint=240),
    dict(black="#123", white="#fea", blackpoint=5, whitepoint=5),
])
def test_colorize_lut_matches_pil_and_hipe_tpu(kw):
    from PIL import Image, ImageOps

    gray = np.random.default_rng(len(str(kw))).integers(0, 256, (24, 30), np.uint8)
    lut3 = teq.colorize_lut(**kw)
    np.testing.assert_array_equal(lut3, heq.colorize_lut(**kw))
    np.testing.assert_array_equal(teq.colorize_oracle(gray, lut3),
                                  np.asarray(ImageOps.colorize(Image.fromarray(gray), **kw)))


def test_colorize_lut_validation():
    with pytest.raises(ValueError, match="blackpoint <= whitepoint"):
        teq.colorize_lut("black", "white", blackpoint=200, whitepoint=100)
    with pytest.raises(ValueError, match="midpoint"):
        teq.colorize_lut("black", "white", mid="gray", blackpoint=0, midpoint=250,
                         whitepoint=200)


def test_colorize_lut_parses_hex_without_pil(monkeypatch):
    want = heq.colorize_lut("navy", "#ffe0a0", mid=(1, 2, 3))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(teq.colorize_lut("#000080", "#ffe0a0", mid=(1, 2, 3)), want)
    with pytest.raises(ValueError, match="colour names need PIL"):
        teq.colorize_lut("navy", "#ffe0a0")


# ---- the serve flags ----


@pytest.mark.parametrize("argv", [
    ["blur3", "--decode-scale", "4", "--gray"],
    ["blur3", "--decode-gray", "--resize", "64", "48", "--decode-on-device",
     "--encode-on-device"],
    ["chain", "--thumbnail", "--encode-on-device"],
    ["blur3", "--decode-gray", "--colorize", "#000080:#ffe0a0:#800000", "--decode-on-device"],
    ["blur3", "--gray", "--colorize", "#000:#fff", "--decode-scale", "8", "--no-encode"],
])
def test_serve_cli_options_run_on_the_cpu(argv, capsys):
    assert cli.main(["serve", *argv, "--device", CPU, "--num-images", "3", "--batch-size", "2",
                     "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["num_images"] == 3 and out["device"] == CPU


@pytest.mark.parametrize("argv,msg", [
    (["--colorize", "red:blue"], "needs a grayscale stage output"),
    (["--gray", "--colorize", "red"], "BLACK:WHITE"),
    (["--gray", "--colorize", "#12:#fff"], "bad --colorize"),
    (["--gray", "--colorize", "0,0,0:#fff"], "bad --colorize"),
    (["--thumbnail", "--resize", "8", "8"], "mutually exclusive"),
    (["--resize", "0", "8"], "positive ints"),
])
def test_serve_cli_option_errors_print_one_line(argv, msg, capsys):
    assert cli.main(["serve", "blur3", *argv, "--device", CPU, "--num-images", "2"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error:") and msg in err[0], err
