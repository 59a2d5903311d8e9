"""The port's JPEG codec on the CPU, held exactly against hipe_tpu and libjpeg.

The host entropy layer (``hipe_tpu_torch.io_.jpeg``, a copy of
``hipe_tpu``'s libjpeg codec), the device decode and encode
(``ops/jpeg_decode.py``, ``ops/jpeg_encode.py``, with kernels K6/K7 as their
plain versions on CPU tensors) and ``ServingPipeline``'s four placements.
Inputs come from numpy seeds; every comparison is exact (pixels, integer
coefficients, or file bytes).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hipe_tpu.io_ import jpeg as hjpeg
from hipe_tpu.models import pipelines as hplib
from hipe_tpu.ops import jpeg_decode as hjd
from hipe_tpu.ops import jpeg_encode as hje
from hipe_tpu.runtime.serve import ServingPipeline as JaxServingPipeline
from hipe_tpu_torch import cli
from hipe_tpu_torch.io_ import jpeg as tjpeg
from hipe_tpu_torch.models import pipelines as tplib
from hipe_tpu_torch.ops import jpeg_decode as tjd
from hipe_tpu_torch.ops import jpeg_encode as tje
from hipe_tpu_torch.runtime.serve import ServingPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _same_coefficients(a, b):
    assert (a.width, a.height, a.max_h, a.max_v, a.progressive, a.color_space) == \
        (b.width, b.height, b.max_h, b.max_v, b.progressive, b.color_space)
    assert len(a.components) == len(b.components)
    for x, y in zip(a.components, b.components):
        assert (x.h_samp, x.v_samp) == (y.h_samp, y.v_samp)
        np.testing.assert_array_equal(x.coefs, y.coefs)
        np.testing.assert_array_equal(x.qtable, y.qtable)


# ---- the host codec copy ----


_CPP_TOKEN = re.compile(r'"(?:\\.|[^"\\])*"|\'(?:\\.|[^\'\\])*\'|//[^\n]*|/\*.*?\*/',
                        re.DOTALL)


def _cpp_code_lines(path):
    """The source's lines with comments and blank lines taken out."""
    with open(path) as f:
        text = f.read()
    code = _CPP_TOKEN.sub(lambda m: "" if m.group().startswith("/") else m.group(), text)
    return [line.rstrip() for line in code.splitlines() if line.strip()]


def test_codec_source_is_a_copy_but_for_comments():
    ref = _cpp_code_lines(os.path.join(ROOT, "hipe_tpu", "csrc", "jpeg_codec.cpp"))
    got = _cpp_code_lines(os.path.join(ROOT, "hipe_tpu_torch", "csrc", "jpeg_codec.cpp"))
    assert len(ref) > 500
    assert got == ref


@pytest.mark.parametrize("quality", range(1, 101))
def test_quality_tables_match_hipe_tpu(quality):
    for got, want in zip(tjpeg.quality_tables(quality), hjpeg.quality_tables(quality)):
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)


STREAMS = [
    *[(sub, {}) for sub in tjpeg._SUB_CODES],
    ("gray", {}),
    ("420", {"progressive": True}),
    ("444", {"arithmetic": True}),
    ("422", {"restart_interval": 2}),
    ("420", {"arithmetic": True, "progressive": True, "restart_interval": 1}),
    ("440", {"optimize": True}),
]


@pytest.mark.parametrize("sub,opts", STREAMS, ids=[f"{s}-{'-'.join(o) or 'baseline'}"
                                                   for s, o in STREAMS])
def test_read_and_write_coefficients_match_hipe_tpu(sub, opts):
    img = _img(33, 41, 1 if sub == "gray" else 3, seed=len(sub) + len(opts))
    layout = "420" if sub == "gray" else sub
    data = hjpeg.encode_bytes_opts(img, quality=80, subsampling=layout, **opts)
    assert tjpeg.encode_bytes_opts(img, quality=80, subsampling=layout, **opts) == data
    co = tjpeg.read_coefficients(data)
    _same_coefficients(co, hjpeg.read_coefficients(data))
    np.testing.assert_array_equal(tjpeg.decode_bytes(data), hjpeg.decode_bytes(data))
    coefs = [c.coefs for c in co.components]
    wsub = "444" if sub == "gray" else sub
    got = tjpeg.write_coefficients(coefs, 41, 33, quality=80, subsampling=wsub, **opts)
    assert got == hjpeg.write_coefficients(coefs, 41, 33, quality=80, subsampling=wsub,
                                           **opts)
    assert got == data


def test_batch_entropy_calls_match_singles():
    datas = [hjpeg.encode_bytes(_img(24, 40, seed=s), 85) for s in range(5)]
    cos = tjpeg.read_coefficients_batch(datas, num_threads=3)
    for co, d in zip(cos, datas):
        _same_coefficients(co, tjpeg.read_coefficients(d))
    stacked = [np.stack([co.components[ci].coefs for co in cos]) for ci in range(3)]
    assert tjpeg.write_coefficients_batch(stacked, 40, 24, quality=85) == datas
    np.testing.assert_array_equal(tjpeg.decode_batch(datas, num_threads=2),
                                  hjpeg.decode_batch(datas))
    assert tjpeg.read_coefficients_batch([]) == []


def test_entropy_layer_rejects_bad_input():
    with pytest.raises(ValueError, match="corrupt|failed"):
        tjpeg.read_coefficients_batch([b"\xff\xd8 not a jpeg"])
    with pytest.raises(ValueError, match="expected"):
        tjpeg.write_coefficients([np.zeros((2, 2, 64), np.int16)], 24, 24, subsampling="444")
    with pytest.raises(ValueError, match="uint8 image"):
        tjpeg.encode_bytes(np.zeros((8, 8, 3), np.int16))
    with pytest.raises(ValueError, match="empty"):
        tjpeg.decode_batch([])


def test_codec_build_failure_raises_and_says_why(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tjpeg, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tjpeg.build()


def test_from_arrays_carries_one_entropy_decode_to_both_decoders():
    data = hjpeg.encode_bytes_opts(_img(29, 35, seed=9), quality=70, subsampling="422")
    ref = hjpeg.read_coefficients(data)
    co = tjpeg.JpegCoefficients.from_arrays(
        ref.width, ref.height, [c.coefs for c in ref.components],
        [c.qtable for c in ref.components], [(c.h_samp, c.v_samp) for c in ref.components])
    _same_coefficients(co, tjpeg.read_coefficients(data))
    got = tjd.decode_coefficients(co, device="cpu").numpy()
    want = np.asarray(hjd.decode_planes(hjd.geometry_of(ref),
                                        [jnp.asarray(c.coefs) for c in ref.components],
                                        [c.qtable for c in ref.components]))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="1 or 3 components"):
        tjpeg.JpegCoefficients.from_arrays(8, 8, [], [], [])


# ---- device decode ----


DECODES = [
    *[(sub, 33, 41, 85, False) for sub in ("420", "422", "444", "440", "411", "410", "311",
                                             "asym")],
    ("gray", 40, 29, 80, False),
    ("420", 16, 4, 85, False),   # widths <= 4: jdsample.c's replication guard
    ("420", 3, 1, 85, False),
    ("422", 16, 3, 85, False),
    ("asym", 16, 4, 85, False),
    ("420", 48, 36, 70, True),   # progressive
    ("444", 24, 24, 5, False),   # quality 5: the widest IDCT range
]


@pytest.mark.parametrize("sub,h,w,quality,progressive", DECODES)
def test_decode_planes_matches_hipe_tpu_and_libjpeg(sub, h, w, quality, progressive):
    img = _img(h, w, 1 if sub == "gray" else 3, seed=h + w)
    data = hjpeg.encode_bytes_opts(img, quality=quality, progressive=progressive,
                                   subsampling="420" if sub == "gray" else sub)
    co = tjpeg.read_coefficients(data)
    geo = tjd.geometry_of(co)
    assert tjd.supported(geo)
    assert tuple(geo) == tuple(hjd.geometry_of(hjpeg.read_coefficients(data)))
    coefs = [torch.from_numpy(np.stack([c.coefs] * 2)) for c in co.components]
    qts = [c.qtable for c in co.components]
    got = tjd.decode_planes(geo, coefs, qts).numpy()
    want = np.asarray(hjd.decode_planes(hjd.geometry_of(co), [jnp.asarray(c.numpy())
                                                              for c in coefs], qts))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], hjpeg.decode_bytes(data))
    rows = tjd.decode_planes(geo, coefs, qts, layout="rows")
    assert rows.shape == (2, h, w * geo.ncomps)
    np.testing.assert_array_equal(rows.numpy().reshape(got.shape), got)


def test_decode_planes_keeps_leading_batch_dims():
    data = hjpeg.encode_bytes(_img(17, 23, seed=4), 75)
    co = tjpeg.read_coefficients(data)
    geo = tjd.geometry_of(co)
    qts = [c.qtable for c in co.components]
    single = tjd.decode_planes(geo, [torch.from_numpy(c.coefs) for c in co.components], qts)
    assert single.shape == (17, 23, 3)
    nested = tjd.decode_planes(
        geo, [torch.from_numpy(np.stack([np.stack([c.coefs] * 3)] * 2)) for c in co.components],
        qts, layout="rows")
    assert nested.shape == (2, 3, 17, 69)
    np.testing.assert_array_equal(nested[1, 2].numpy().reshape(17, 23, 3), single.numpy())
    with pytest.raises(ValueError, match="layout"):
        tjd.decode_planes(geo, [torch.from_numpy(c.coefs) for c in co.components], qts,
                          layout="nhwc")


def test_batch_decoder_matches_single_decodes():
    datas = [hjpeg.encode_bytes_opts(_img(16, 24, seed=s), 75, "420") for s in range(4)]
    cos = [tjpeg.read_coefficients(d) for d in datas]
    fn = tjd.make_batch_decoder(tjd.geometry_of(cos[0]), [c.qtable for c in cos[0].components])
    out = fn(*[torch.from_numpy(np.stack([co.components[ci].coefs for co in cos]))
               for ci in range(3)]).numpy()
    assert out.shape == (4, 16, 24, 3)
    for o, co, d in zip(out, cos, datas):
        np.testing.assert_array_equal(o, tjd.decode_coefficients(co, device="cpu").numpy())
        np.testing.assert_array_equal(o, hjpeg.decode_bytes(d))


def test_four_component_streams_raise_naming_the_roadmap():
    # 4-component streams are ported: they decode, as hipe_tpu's and libjpeg do.
    data = hjpeg.encode_cmyk_bytes(_img(16, 16, 4, seed=1), ycck=True)
    co = tjpeg.read_coefficients(data)
    geo = tjd.geometry_of(co)
    assert geo.ncomps == 4 and geo.color == 5 and tjd.supported(geo)
    got = tjd.decode_coefficients(co, device="cpu").numpy()
    np.testing.assert_array_equal(got, hjpeg.decode_bytes(data))
    np.testing.assert_array_equal(got, np.asarray(hjd.decode_coefficients(
        hjpeg.read_coefficients(data))))


def test_unsupported_geometries_match_hipe_tpu():
    geos = [
        tjd.DecodeGeometry(16, 16, 3, ((1, 1, 2, 2), (2, 1, 4, 2), (1, 1, 2, 2)), 2, 1),
        tjd.DecodeGeometry(16, 16, 3, ((3, 1, 6, 2), (2, 1, 4, 2), (2, 1, 4, 2)), 3, 1),
        tjd.DecodeGeometry(16, 16, 2, ((1, 1, 2, 2), (1, 1, 2, 2)), 1, 1),
        tjd.DecodeGeometry(16, 16, 3, ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1)), 2, 2),
    ]
    for geo in geos:
        assert tjd.supported(geo) == hjd.supported(hjd.DecodeGeometry(*geo))
    with pytest.raises(ValueError, match="unsupported"):
        tjd.decode_planes(geos[0], [torch.zeros((2, 2, 64), dtype=torch.int16)] * 3,
                          [np.ones(64)] * 3)


@pytest.mark.parametrize("hr,vr", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (3, 1)])
@pytest.mark.parametrize("w", [1, 2, 3, 9])
def test_upsample_component_matches_hipe_tpu(hr, vr, w):
    plane = _img(2, 7 * w, 1, seed=hr * 10 + vr)[..., 0].reshape(2, 7, w)
    got = tjd.upsample_component(torch.from_numpy(plane), hr, vr).numpy()
    want = np.asarray(hjd.upsample_component(jnp.asarray(plane), hr, vr))
    np.testing.assert_array_equal(got, want)


def test_colour_conversions_match_hipe_tpu():
    rgb = _img(9, 11, seed=3)
    for got, want in zip(tje.rgb_to_ycc(torch.from_numpy(rgb)),
                         hje.rgb_to_ycc(jnp.asarray(rgb))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tje.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(hje.rgb_to_gray(jnp.asarray(rgb))))
    y, cb, cr = (_img(9, 11, 1, seed=s)[..., 0] for s in (4, 5, 6))
    np.testing.assert_array_equal(
        tjd.ycc_to_rgb(*(torch.from_numpy(p) for p in (y, cb, cr))).numpy(),
        np.asarray(hjd.ycc_to_rgb(*(jnp.asarray(p, jnp.int32) for p in (y, cb, cr)))))


def test_downsamplers_match_hipe_tpu():
    plane = _img(12, 24, 1, seed=8)[..., 0].astype(np.int32)
    t, j = torch.from_numpy(plane), jnp.asarray(plane)
    np.testing.assert_array_equal(tje.downsample_h2v2(t).numpy(),
                                  np.asarray(hje.downsample_h2v2(j)))
    np.testing.assert_array_equal(tje.downsample_h2v1(t).numpy(),
                                  np.asarray(hje.downsample_h2v1(j)))
    for he, ve in ((4, 1), (4, 2), (3, 1), (2, 2)):
        np.testing.assert_array_equal(tje.downsample_int(t, he, ve).numpy(),
                                      np.asarray(hje.downsample_int(j, he, ve)))
    np.testing.assert_array_equal(tje._pad_edge(t, 15, 29).numpy(),
                                  np.asarray(hje._pad_edge(j, 15, 29)))


# ---- device encode ----


ENCODES = [(sub, 33, 29) for sub in tje.DEVICE_SUBSAMPLINGS] + [
    ("gray", 33, 29), ("420", 24, 40), ("420", 3, 5), ("asym", 17, 9)]


@pytest.mark.parametrize("sub,h,w", ENCODES)
def test_encode_planes_matches_hipe_tpu_and_libjpeg(sub, h, w):
    gray = sub == "gray"
    img = _img(h, w, 1 if gray else 3, seed=h * w)
    geo = tje.encode_geometry(h, w, 1 if gray else 3, "444" if gray else sub)
    assert tuple(geo) == tuple(hje.encode_geometry(h, w, 1 if gray else 3,
                                                   "444" if gray else sub))
    luma, chroma = tjpeg.quality_tables(77)
    qts = [luma] if gray else [luma, chroma, chroma]
    x = img[..., 0] if gray else img
    got = tje.encode_planes(geo, torch.from_numpy(np.stack([x, x])), qts)
    want = hje.encode_planes(hje.DecodeGeometry(*geo), jnp.asarray(np.stack([x, x])), qts)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    out = tjpeg.write_coefficients([g[1].numpy() for g in got], w, h, quality=77,
                                   subsampling="444" if gray else sub)
    assert out == tjpeg.encode_bytes_opts(img, quality=77, subsampling="420" if gray else sub)


def test_encode_bytes_device_matches_the_host_codec():
    img = _img(21, 30, seed=12)
    for sub, prog in (("420", False), ("440", True)):
        got = tje.encode_bytes_device(img, 83, sub, progressive=prog, device="cpu")
        assert got == tjpeg.encode_bytes_opts(img, 83, sub, progressive=prog)
    gray = _img(21, 30, 1, seed=13)
    assert tje.encode_bytes_device(gray, 60, device="cpu") == tjpeg.encode_bytes(gray, 60)


def test_encode_planes_rejects_bad_pixels():
    geo = tje.encode_geometry(8, 8, 3)
    with pytest.raises(ValueError, match="expected"):
        tje.encode_planes(geo, torch.zeros((8, 9, 3), dtype=torch.uint8), [np.ones(64)] * 3)
    with pytest.raises(TypeError, match="uint8"):
        tje.encode_planes(geo, torch.zeros((8, 8, 3), dtype=torch.int32), [np.ones(64)] * 3)
    with pytest.raises(ValueError, match="grayscale"):
        tje.encode_planes(tje.encode_geometry(8, 8, 1), torch.zeros((8, 9), dtype=torch.uint8),
                          [np.ones(64)])


# ---- serving ----


def _payloads(n=4, h=24, w=40, seed=0, subs=("420",)):
    return [tjpeg.encode_bytes_opts(_img(h, w, seed=seed + i), 90, subs[i % len(subs)])
            for i in range(n)]


PLACEMENTS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(scope="module")
def blur3_reference():
    """hipe_tpu's host placement over a mixed-layout batch (two groups)."""
    payloads = _payloads(subs=("420", "444"))
    sp = JaxServingPipeline("blur3", use_pallas=False)
    return payloads, sp.process_batch(payloads), sp.process_batch(payloads, encode=False)


@pytest.mark.parametrize("dec,enc", PLACEMENTS)
def test_placements_give_hipe_tpu_bytes(blur3_reference, dec, enc):
    payloads, want, pixels = blur3_reference
    with ServingPipeline("blur3", device=CPU, decode_on_device=dec,
                         encode_on_device=enc) as sp:
        assert sp.process_batch(payloads) == want
        np.testing.assert_array_equal(sp.process_batch(payloads, encode=False), pixels)


@pytest.mark.parametrize("opts", [{"encode_progressive": True}, {"encode_arithmetic": True},
                                  {"encode_restart_interval": 3}, {"encode_optimize": True},
                                  {"encode_subsampling": "422"}])
def test_entropy_options_hold_across_placements(opts):
    payloads = _payloads(n=2, seed=5)
    want = JaxServingPipeline("chain", use_pallas=False, **opts).process_batch(payloads)
    for dec, enc in PLACEMENTS:
        with ServingPipeline("chain", device=CPU, decode_on_device=dec, encode_on_device=enc,
                             **opts) as sp:
            assert sp.process_batch(payloads) == want, (dec, enc)


def test_transcode_coefficients_match_hipe_tpu_decode_filter_encode():
    payloads = _payloads(n=3, h=19, w=27, seed=7)
    cos = tjpeg.read_coefficients_batch(payloads)
    geo = tjd.geometry_of(cos[0])
    qkey = tuple(tuple(int(v) for v in c.qtable) for c in cos[0].components)
    comps = [np.stack([co.components[ci].coefs for co in cos]) for ci in range(3)]
    sp = ServingPipeline("blur3", device=CPU, decode_on_device=True, encode_on_device=True)
    got = sp.transcode_fn(geo, qkey)(*[torch.from_numpy(c) for c in comps])
    sp.close()
    qts = [c.qtable for c in cos[0].components]
    hgeo = hjd.DecodeGeometry(*geo)
    rows = hjd.decode_planes(hgeo, [jnp.asarray(c) for c in comps], qts, layout="rows")
    rows = hplib.get("blur3").apply_rows(rows, 3, use_pallas=False)
    luma, chroma = hjpeg.quality_tables(90)
    want = hje.encode_planes(hje.encode_geometry(19, 27, 3, "420"),
                             rows.reshape(3, 19, 27, 3), [luma, chroma, chroma])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_run_overlaps_batches_and_counts_images():
    payloads = _payloads(n=6, seed=11)
    want = JaxServingPipeline("denoise", use_pallas=False).process_batch(payloads)
    with ServingPipeline(tplib.get("denoise"), device=CPU, decode_on_device=True,
                         encode_on_device=True) as sp:
        out = [b for batch in sp.run([payloads[:2], payloads[2:4], payloads[4:]]) for b in batch]
        assert out == want
        assert sp.stats.images == 6 and sp.stats.wall_ms > 0 and sp.stats.img_per_s > 0
        assert sp.stats.decode_ms > 0 and sp.stats.encode_ms > 0


def test_unsupported_geometry_falls_back_to_the_host_decode():
    # Gray and 4:1:1 streams both decode on the card; CMYK goes to the host
    # decode, which refuses 4-channel serving.
    gray = tjpeg.encode_bytes(_img(16, 24, 1, seed=2), 90)
    with ServingPipeline("blur3", device=CPU, decode_on_device=True,
                         encode_on_device=True) as sp:
        assert sp.process_batch([gray]) == ServingPipeline(
            "blur3", device=CPU).process_batch([gray])
        cmyk = hjpeg.encode_cmyk_bytes(_img(16, 16, 4, seed=3))
        with pytest.raises(ValueError, match="4-component"):
            sp.process_batch([cmyk])


@pytest.mark.parametrize("option,value", [
    ("output_scale", 2), ("resize_to", (8, 8)), ("decode_scale", 2), ("gray_output", True),
    ("decode_gray", True), ("colorize", np.zeros((3, 256), np.uint8)),
])
def test_unported_serving_options_raise(option, value):
    # The options are ported: each gives hipe_tpu's bytes, or its error
    # (colorize on a colour stage output).
    payloads = _payloads(n=2, seed=13)
    try:
        want = JaxServingPipeline("blur3", use_pallas=False,
                                  **{option: value}).process_batch(payloads)
    except ValueError as e:
        want = e
    with ServingPipeline("blur3", device=CPU, decode_on_device=True, encode_on_device=True,
                         **{option: value}) as sp:
        if isinstance(want, ValueError):
            with pytest.raises(ValueError, match="grayscale stage output"):
                sp.process_batch(payloads)
            assert option == "colorize" and "grayscale stage output" in str(want)
        else:
            assert sp.process_batch(payloads) == want


def test_serving_checks_its_device_and_layout():
    with pytest.raises(ValueError, match="encode_subsampling"):
        ServingPipeline("blur3", device=CPU, encode_subsampling="421")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ServingPipeline("blur3")


@pytest.mark.parametrize("argv", [
    ["blur3", "--decode-on-device", "--encode-on-device"],
    ["chain", "--encode-subsampling", "444", "--encode-arithmetic"],
    ["gaussian3,torchport_serve_dim", "--lut", "torchport_serve_dim=brightness:0.5",
     "--decode-on-device", "--no-encode"],
    ["blur3", "--encode-on-device", "--encode-progressive", "--encode-optimize",
     "--encode-restart-interval", "2", "--quality", "75"],
])
def test_serve_cli_runs_on_the_cpu(argv, capsys):
    assert cli.main(["serve", *argv, "--device", "cpu", "--num-images", "5",
                     "--batch-size", "2", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["num_images"] == 5 and out["device"] == "cpu" and out["img_per_s"] > 0


def test_serve_cli_image_and_errors(tmp_path, capsys):
    path = tmp_path / "in.jpg"
    path.write_bytes(tjpeg.encode_bytes(_img(20, 12, seed=1), 95))
    assert cli.main(["serve", "edge", "--image", str(path), "--device", "cpu",
                     "--num-images", "3", "--json"]) == 0
    assert "in.jpg" in capsys.readouterr().out
    assert cli.main(["serve", "blur3", "--image", str(tmp_path / "missing.jpg"),
                     "--device", "cpu"]) == 1
    assert "cannot load input image" in capsys.readouterr().err
    assert cli.main(["serve", "nope", "--device", "cpu"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("Error:") and "unknown pipeline" in err[0]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            cli.main(["serve", "blur3", "--num-images", "2"])
