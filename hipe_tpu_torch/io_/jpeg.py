"""JPEG entropy layer: the native libjpeg codec, bound with ctypes.

The port's own copy of ``hipe_tpu.io_.jpeg`` (which it cannot import: any
``hipe_tpu`` module pulls in JAX). ``csrc/jpeg_codec.cpp`` is
``hipe_tpu/csrc/jpeg_codec.cpp`` line for line, only its comments differ; at
first use it is built with::

    g++ -O2 -shared -fPIC -o build/hipe_tpu_torch/jpeg-<hash>/libhipejpeg.so \\
        hipe_tpu_torch/csrc/jpeg_codec.cpp -ljpeg -lpthread

``<hash>`` hashes the source; ``build/`` is git-ignored. The build needs g++
and libjpeg (``jpeglib.h`` and ``-ljpeg``); where either is missing every
function here raises and says so. There is no PIL fallback.

The host does the serial work: Huffman or arithmetic entropy decode to
quantized DCT coefficients (:func:`read_coefficients_batch`) and the entropy
encode of coefficients back to a file (:func:`write_coefficients_batch`).
Dequantize, IDCT, upsampling, colour conversion, filtering, downsampling,
fDCT and quantization run on the card (``ops/jpeg_decode.py``,
``ops/jpeg_encode.py``). :func:`decode_bytes`, :func:`decode_batch`,
:func:`encode_bytes` and :func:`encode_bytes_opts` are whole-image host
codecs: the host placements of ``runtime/serve.py`` and the tests' oracle;
their scaled (:func:`decode_bytes_scaled`, :func:`decode_batch_scaled`) and
grayscale (``force_gray``, ``gray_from_rgb``) forms and
:func:`encode_cmyk_bytes` too. :func:`read_markers` and the ``qtables`` and
``markers`` of :func:`write_coefficients` serve the lossless transforms.
:func:`quality_tables` is pure Python, so the device codec needs no libjpeg.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from hipe_tpu_torch.ops._build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_codec.cpp"
LIB_NAME = "libhipejpeg.so"

# Annex K tables K.1 and K.2 (ITU-T T.81), natural order: jcparam.c's
# std_luminance_quant_tbl and std_chrominance_quant_tbl.
_STD_LUMA = (
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
)
_STD_CHROMA = (
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    *(99,) * 32,
)


def build_dir() -> Path:
    """``build/hipe_tpu_torch/jpeg-<hash of jpeg_codec.cpp>``."""
    return BUILD_ROOT / f"jpeg-{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]}"


def build() -> Path:
    """Compile the codec if this source hash has no library yet; return it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE),
           "-ljpeg", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native JPEG codec is built from "
                           f"{SOURCE} at first use") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            "the native JPEG codec did not build (it needs g++, jpeglib.h and "
            f"libjpeg): {' '.join(cmd)}\n{proc.stderr.strip()}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def _load() -> ctypes.CDLL:
    """The native codec, built on first call; raises if it cannot be."""
    lib = ctypes.CDLL(str(build()))
    ci, csz = ctypes.c_int, ctypes.c_size_t
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    i16p = ctypes.POINTER(ctypes.c_int16)
    ip = ctypes.POINTER(ci)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    szp = ctypes.POINTER(csz)
    sigs = {
        "hipe_jpeg_dims": [u8p, csz, ip, ip, ip],
        "hipe_jpeg_decode": [u8p, csz, u8p, ci, ci, ci],
        "hipe_jpeg_encode": [u8p, ci, ci, ci, ci, u8p, csz, szp],
        "hipe_jpeg_decode_batch": [ctypes.POINTER(u8p), szp, ci, u8p, ci, ci, ci, ci],
        "hipe_jpeg_coef_info": [u8p, csz, ip],
        "hipe_jpeg_read_coefs": [u8p, csz, ctypes.POINTER(i16p), u16p],
        "hipe_jpeg_encode_opts": [u8p, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                  u8p, csz, szp],
        "hipe_jpeg_write_coefs": [ci, ci, ci, ci, ci, ci, ci, ci, ci, u16p, u8p, csz,
                                  ctypes.POINTER(i16p), u8p, csz, szp],
        "hipe_jpeg_coef_info_batch": [ctypes.POINTER(u8p), szp, ci, ip, ip, ci],
        "hipe_jpeg_read_coefs_batch": [ctypes.POINTER(u8p), szp, ci,
                                       ctypes.POINTER(i16p), u16p, ip, ci],
        "hipe_jpeg_write_coefs_batch": [ci, ci, ci, ci, ci, ci, ci, ci, ci, u16p,
                                        ctypes.POINTER(i16p), ci, u8p, csz, szp,
                                        ip, ci],
        "hipe_jpeg_encode_cmyk": [u8p, ci, ci, ci, ci, ci, u8p, csz, szp],
        "hipe_jpeg_read_markers": [u8p, csz, u8p, csz, szp],
        "hipe_jpeg_scaled_dims": [u8p, csz, ci, ci, ip, ip, ip],
        "hipe_jpeg_decode_scaled": [u8p, csz, u8p, ci, ci, ci, ci, ci],
        "hipe_jpeg_scaled_info": [u8p, csz, ci, ci, ip],
        "hipe_jpeg_decode_scaled_batch": [ctypes.POINTER(u8p), szp, ci, u8p, ci, ci, ci,
                                          ci, ci, ci],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    return lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def _check_image(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got {img.dtype} "
                         f"of shape {img.shape}")
    return np.ascontiguousarray(img)


def _gray_channels(c: int, force_gray: bool) -> int:
    """Output channels of a decode; ``force_gray`` makes colour streams 1.
    libjpeg has no grayscale conversion of 4-component streams."""
    if not force_gray:
        return c
    if c == 4:
        raise ValueError("4-component (CMYK) streams have no grayscale conversion in libjpeg")
    return 1


def decode_bytes(data: bytes, force_gray: bool = False) -> np.ndarray:
    """Decode a JPEG byte string to HWC uint8: RGB (C = 3), grayscale
    (C = 1), or CMYK samples as libjpeg emits them for 4-component Adobe
    streams (C = 4; YCCK through the library's Adobe transform).
    ``force_gray`` decodes colour streams with ``out_color_space =
    JCS_GRAYSCALE`` (the luma's IDCT alone, chroma never touched);
    4-component streams raise."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.hipe_jpeg_dims(_as_u8p(buf), buf.size, w, h, c) != 0:
        raise ValueError("invalid JPEG header")
    channels = _gray_channels(c.value, force_gray)
    out = np.empty((h.value, w.value, channels), dtype=np.uint8)
    rc = lib.hipe_jpeg_decode(_as_u8p(buf), buf.size, _as_u8p(out),
                              w.value, h.value, channels)
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_batch(datas: list[bytes], num_threads: int | None = None,
                 force_gray: bool = False) -> np.ndarray:
    """Decode same-shaped JPEGs concurrently into one (B, H, W, C) batch."""
    if not datas:
        raise ValueError("empty batch")
    lib = _load()
    first = decode_bytes(datas[0], force_gray=force_gray)
    h, w, c = first.shape
    out = np.empty((len(datas), h, w, c), dtype=np.uint8)
    out[0] = first
    if len(datas) > 1:
        keep, ptrs, lens = _batch_ptrs(datas[1:])
        nt = num_threads or min(os.cpu_count() or 1, len(keep))
        fails = lib.hipe_jpeg_decode_batch(ptrs, lens, len(keep), _as_u8p(out[1:]),
                                           w, h, c, nt)
        if fails:
            raise ValueError(f"{fails} images failed to decode")
    return out


def scaled_dims(data: bytes, scale_num: int, scale_denom: int) -> tuple[int, int, int]:
    """(H, W, C) of a libjpeg scaled decode at ``scale_num/scale_denom``:
    libjpeg normalizes the ratio to M/8 (M in 1..16) and the output dims are
    ceil(dim * M / 8) (``jpeg_calc_output_dimensions``)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.hipe_jpeg_scaled_dims(_as_u8p(buf), buf.size, scale_num, scale_denom, w, h, c):
        raise ValueError("invalid JPEG header")
    return h.value, w.value, c.value


def scaled_info(data: bytes, scale_num: int, scale_denom: int):
    """libjpeg's geometry at a scaled decode, probed without decoding:
    ``((out_w, out_h), [(dct_scaled_size, down_w, down_h), ...])``, the
    scaled DCT size jdmaster.c picks for each component and its downsampled
    dims. The ground truth of :func:`hipe_tpu_torch.ops.jpeg_decode.scaled_sizes`."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    info = (ctypes.c_int * 18)()
    rc = lib.hipe_jpeg_scaled_info(_as_u8p(buf), buf.size, scale_num, scale_denom, info)
    if rc != 0:
        raise ValueError(f"JPEG scaled-info probe failed (rc={rc})")
    # One 4-int record a header component; DCT_scaled_size is at least 1, so
    # the first zero record (the array starts zeroed) ends the list.
    comps = []
    for i in range(4):
        rec = info[2 + 4 * i: 2 + 4 * (i + 1)]
        if rec[0] == 0:
            break
        comps.append((rec[0], rec[1], rec[2]))
    return (info[0], info[1]), comps


def decode_bytes_scaled(data: bytes, scale_num: int, scale_denom: int,
                        force_gray: bool = False) -> np.ndarray:
    """Decode at ``scale_num/scale_denom`` by libjpeg's DCT-domain scaling:
    the host decode of thumbnail serving and the oracle of
    :func:`hipe_tpu_torch.ops.jpeg_decode.decode_planes_scaled`.
    ``force_gray`` as in :func:`decode_bytes`."""
    lib = _load()
    h, w, c = scaled_dims(data, scale_num, scale_denom)
    c = _gray_channels(c, force_gray)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((h, w, c), dtype=np.uint8)
    rc = lib.hipe_jpeg_decode_scaled(_as_u8p(buf), buf.size, _as_u8p(out), w, h, c,
                                     scale_num, scale_denom)
    if rc != 0:
        raise ValueError(f"scaled JPEG decode failed (rc={rc})")
    return out


def decode_batch_scaled(datas: list[bytes], scale_num: int, scale_denom: int,
                        num_threads: int | None = None,
                        force_gray: bool = False) -> np.ndarray:
    """:func:`decode_bytes_scaled` of same-shaped JPEGs into one
    (B, H, W, C) batch, on the native thread pool."""
    if not datas:
        raise ValueError("empty batch")
    lib = _load()
    first = decode_bytes_scaled(datas[0], scale_num, scale_denom, force_gray=force_gray)
    h, w, c = first.shape
    out = np.empty((len(datas), h, w, c), dtype=np.uint8)
    out[0] = first
    if len(datas) > 1:
        keep, ptrs, lens = _batch_ptrs(datas[1:])
        nt = num_threads or min(os.cpu_count() or 1, len(keep))
        fails = lib.hipe_jpeg_decode_scaled_batch(ptrs, lens, len(keep), _as_u8p(out[1:]),
                                                  w, h, c, scale_num, scale_denom, nt)
        if fails:
            raise ValueError(f"{fails} images failed to decode")
    return out


def decode_file(path: str) -> np.ndarray:
    """Decode a JPEG file to HWC uint8 (``hipe_tpu``'s ``decode_file``
    without its PIL route for other formats, which raises here)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path} is not a JPEG file (no SOI marker)")
    return decode_bytes(data)


def _run_encode(call, cap0: int) -> bytes:
    """Run a native encode call; on rc=3 (did not fit) retry at the exact
    size the C side reports in out_len."""
    out = np.empty(cap0, dtype=np.uint8)
    out_len = ctypes.c_size_t()
    rc = call(_as_u8p(out), ctypes.c_size_t(cap0), out_len)
    if rc == 3:
        out = np.empty(out_len.value, dtype=np.uint8)
        rc = call(_as_u8p(out), ctypes.c_size_t(out.size), out_len)
    if rc != 0:
        raise ValueError(f"JPEG encode failed (rc={rc})")
    return out[: out_len.value].tobytes()


def encode_bytes(img: np.ndarray, quality: int = 90) -> bytes:
    """Encode HWC uint8 to JPEG bytes (libjpeg defaults: 4:2:0 for colour)."""
    lib = _load()
    img = _check_image(img)
    h, w, c = img.shape
    return _run_encode(
        lambda out, cap, out_len: lib.hipe_jpeg_encode(
            _as_u8p(img), w, h, c, quality, out, cap, out_len),
        w * h * c + 65536)


def encode_file(img: np.ndarray, path: str, quality: int = 90) -> None:
    """Save HWC uint8 as a JPEG file (``hipe_tpu``'s ``encode_file`` for
    ``.jpg``/``.jpeg``/no extension; other formats raise here)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in ("", ".jpg", ".jpeg"):
        raise ValueError(f"{path}: only JPEG output is supported (.jpg, .jpeg)")
    data = encode_bytes(img, quality)
    with open(path, "wb") as f:
        f.write(data)


# ---- Entropy-only decode and encode (the host half of the device codec) ----


@dataclasses.dataclass
class ComponentCoefs:
    """One component's quantized DCT coefficients (entropy-decoded only)."""

    coefs: np.ndarray  # (height_in_blocks, width_in_blocks, 64) int16, natural order
    qtable: np.ndarray  # (64,) uint16, natural order (jdmarker.c get_dqt)
    h_samp: int
    v_samp: int


@dataclasses.dataclass
class JpegCoefficients:
    """Entropy-decoded JPEG: everything the card needs to finish decoding."""

    width: int
    height: int
    components: list[ComponentCoefs]
    max_h: int
    max_v: int
    progressive: bool
    # libjpeg's J_COLOR_SPACE after the header: 1 grayscale, 3 YCbCr,
    # 4 CMYK, 5 YCCK.
    color_space: int = 3

    @property
    def num_components(self) -> int:
        return len(self.components)

    @classmethod
    def from_arrays(cls, width: int, height: int, coefs, qtables, samplings,
                    progressive: bool = False,
                    color_space: int | None = None) -> "JpegCoefficients":
        """Build one from numpy arrays: ``coefs[i]`` (Hb_i, Wb_i, 64) int16,
        ``qtables[i]`` (64,), ``samplings[i]`` (h_samp, v_samp). The colour
        space defaults to YCbCr for 3 components and grayscale for 1; 4
        components need it given, 4 (CMYK) or 5 (YCCK)."""
        n = len(coefs)
        if not n == len(qtables) == len(samplings) or n not in (1, 3, 4):
            raise ValueError("expected 1 or 3 components (or 4 with a CMYK/YCCK "
                             "color_space), each with coefficients, a quant table and "
                             "its sampling factors")
        if color_space is None:
            if n == 4:
                raise ValueError("4 components need color_space 4 (CMYK) or 5 (YCCK)")
            color_space = 3 if n == 3 else 1
        comps = [ComponentCoefs(coefs=np.asarray(c, dtype=np.int16),
                                qtable=np.asarray(q, dtype=np.uint16).reshape(64),
                                h_samp=int(hs), v_samp=int(vs))
                 for c, q, (hs, vs) in zip(coefs, qtables, samplings)]
        return cls(width=int(width), height=int(height), components=comps,
                   max_h=max(c.h_samp for c in comps), max_v=max(c.v_samp for c in comps),
                   progressive=bool(progressive), color_space=int(color_space))

    @classmethod
    def from_coefficients(cls, co) -> "JpegCoefficients":
        """A copy of any object with this class's fields (``hipe_tpu``'s
        ``JpegCoefficients`` among them): dims, each component's
        coefficients, quant table and sampling, progressive, colour space."""
        return cls.from_arrays(
            co.width, co.height, [c.coefs for c in co.components],
            [c.qtable for c in co.components],
            [(c.h_samp, c.v_samp) for c in co.components],
            progressive=co.progressive, color_space=co.color_space)


_INFO_LEN = 27  # mirrors INFO_LEN in jpeg_codec.cpp


def read_coefficients(data: bytes) -> JpegCoefficients:
    """Entropy-decode a JPEG to quantized DCT coefficients (no IDCT)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    info = (ctypes.c_int * _INFO_LEN)()
    rc = lib.hipe_jpeg_coef_info(_as_u8p(buf), buf.size, info)
    if rc != 0:
        raise ValueError(f"JPEG coefficient scan failed (rc={rc})")
    ncomps = info[0]
    arrays, qnos, samps = [], [], []
    for i in range(ncomps):
        h_samp, v_samp, wb, hb, qno = info[6 + 5 * i: 6 + 5 * (i + 1)]
        arrays.append(np.empty((hb, wb, 64), dtype=np.int16))
        qnos.append(qno)
        samps.append((h_samp, v_samp))
    qtabs = np.zeros((4, 64), dtype=np.uint16)
    i16p = ctypes.POINTER(ctypes.c_int16)
    ptrs = (i16p * ncomps)(*[a.ctypes.data_as(i16p) for a in arrays])
    rc = lib.hipe_jpeg_read_coefs(_as_u8p(buf), buf.size, ptrs,
                                  qtabs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"JPEG coefficient decode failed (rc={rc})")
    return JpegCoefficients(
        width=info[1], height=info[2],
        components=[ComponentCoefs(coefs=a, qtable=qtabs[qno].copy(), h_samp=hs, v_samp=vs)
                    for a, qno, (hs, vs) in zip(arrays, qnos, samps)],
        max_h=info[3], max_v=info[4], progressive=bool(info[5]), color_space=int(info[26]))


# Subsampling name -> native codec code (jpeg_codec.cpp apply_subsamp) and
# per-component (h_samp, v_samp). "asym" is a legal mismatched-chroma layout.
_SUB_CODES = {
    "420": 0, "444": 1, "422": 2, "440": 3,
    "411": 4, "410": 5, "asym": 6, "311": 7,
}
_SUB_FACTORS = {
    "420": ((2, 2), (1, 1), (1, 1)),
    "444": ((1, 1), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "410": ((4, 2), (1, 1), (1, 1)),
    "asym": ((2, 2), (2, 1), (1, 1)),
    "311": ((3, 1), (1, 1), (1, 1)),
}


def encode_bytes_opts(
    img: np.ndarray,
    quality: int = 90,
    subsampling: str = "420",
    progressive: bool = False,
    arithmetic: bool = False,
    restart_interval: int = 0,
    gray_from_rgb: bool = False,
    optimize: bool = False,
) -> bytes:
    """Encode with a chroma layout (a ``_SUB_CODES`` name) and the entropy
    options: progressive scans, arithmetic coding, restart markers every
    ``restart_interval`` MCUs (0: none), optimal Huffman tables. None of the
    options changes the quantized coefficients. ``gray_from_rgb`` encodes an
    RGB image as a 1-component file through libjpeg's own RGB -> grayscale
    conversion (jccolor.c rgb_gray_convert)."""
    sub_code = _SUB_CODES[subsampling]
    lib = _load()
    img = _check_image(img)
    h, w, c = img.shape
    return _run_encode(
        lambda out, cap, out_len: lib.hipe_jpeg_encode_opts(
            _as_u8p(img), w, h, c, quality, sub_code, int(progressive),
            int(arithmetic), int(restart_interval), int(gray_from_rgb), int(optimize),
            out, cap, out_len),
        w * h * c + 65536)


def encode_cmyk_bytes(img: np.ndarray, quality: int = 90, ycck: bool = False,
                      progressive: bool = False) -> bytes:
    """Encode an (H, W, 4) CMYK image, samples as given (the Adobe
    inversion is the caller's concern: decode returns the same values).
    ``ycck`` stores Adobe YCCK (transform 2, subsampled chroma), else plain
    CMYK (transform 0, every component at full resolution); both carry the
    Adobe APP14 marker, so decoders classify them as libjpeg does."""
    img = _check_image(img)
    if img.shape[2] != 4:
        raise ValueError(f"expected an (H, W, 4) CMYK image, got shape {img.shape}")
    lib = _load()
    h, w, _ = img.shape
    return _run_encode(
        lambda out, cap, out_len: lib.hipe_jpeg_encode_cmyk(
            _as_u8p(img), w, h, quality, int(ycck), int(progressive), out, cap, out_len),
        w * h * 4 + 65536)


def read_markers(data: bytes) -> list[tuple[int, bytes]]:
    """The COM and APP1..APP13 markers of a JPEG stream in file order, as
    (marker code, payload): Exif (APP1 = 0xE1), ICC (APP2), XMP, comments
    (COM = 0xFE). APP0/JFIF and APP14/Adobe are left out: the writer makes
    its own. What jpegtran's ``-copy`` carries."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + 4096
    out = np.empty(cap, dtype=np.uint8)
    out_len = ctypes.c_size_t()
    rc = lib.hipe_jpeg_read_markers(_as_u8p(buf), buf.size, _as_u8p(out), cap, out_len)
    if rc == 3:
        out = np.empty(int(out_len.value), dtype=np.uint8)
        rc = lib.hipe_jpeg_read_markers(_as_u8p(buf), buf.size, _as_u8p(out), out.size,
                                        out_len)
    if rc != 0:
        raise ValueError(f"marker read failed (rc={rc})")
    raw = out[: int(out_len.value)].tobytes()
    res: list[tuple[int, bytes]] = []
    p = 0
    while p < len(raw):
        code = int.from_bytes(raw[p:p + 4], "little")
        dlen = int.from_bytes(raw[p + 4:p + 8], "little")
        res.append((code, raw[p + 8:p + 8 + dlen]))
        p += 8 + dlen
    return res


def _qt_override_buf(qtables: list) -> np.ndarray:
    """(2, 64) uint16 tables for the writer's two slots: component 0 takes
    the luma slot, components 1 and 2 the chroma slot. A stream whose Cb and
    Cr tables differ cannot be written without requantizing one of them, so
    it raises instead of corrupting Cr."""
    qt_buf = np.zeros((2, 64), dtype=np.uint16)
    qt_buf[0] = np.asarray(qtables[0], dtype=np.uint16)
    if len(qtables) > 1:
        qt_buf[1] = np.asarray(qtables[1], dtype=np.uint16)
        for extra in qtables[2:]:
            if not np.array_equal(qt_buf[1], np.asarray(extra, dtype=np.uint16)):
                raise ValueError("stream's chroma components use different quant tables; "
                                 "the two-slot writer cannot represent that losslessly")
    return qt_buf


def _qt_ptr(qtables):
    """(keepalive, pointer) of the table override, or (None, None)."""
    if qtables is None:
        return None, None
    buf = _qt_override_buf(qtables)
    return buf, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quant tables jpeg_set_quality installs, natural order.

    jcparam.c's rule in pure Python (no libjpeg): quality clamped to 1..100,
    ``scale = 5000 // q`` below 50 and ``200 - 2q`` from 50, each entry
    ``(base * scale + 50) // 100`` clamped to 1..255 (force_baseline).
    """
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def table(base):
        return np.array([min(max((b * scale + 50) // 100, 1), 255) for b in base],
                        dtype=np.uint16)

    return table(_STD_LUMA), table(_STD_CHROMA)


def _coef_block_shapes(width: int, height: int, ncomps: int,
                       subsampling: str) -> list[tuple[int, int]]:
    """(Hb, Wb) per component for the unpadded block grid (jdinput.c math)."""
    samps = [(1, 1)] if ncomps == 1 else list(_SUB_FACTORS[subsampling])
    max_h = max(s[0] for s in samps)
    max_v = max(s[1] for s in samps)
    return [(-(-height * v // (8 * max_v)), -(-width * h // (8 * max_h)))
            for h, v in samps]


def write_coefficients(
    coefs: list[np.ndarray],
    width: int,
    height: int,
    quality: int = 90,
    subsampling: str = "420",
    progressive: bool = False,
    arithmetic: bool = False,
    restart_interval: int = 0,
    optimize: bool = False,
    qtables: list[np.ndarray] | None = None,
    markers: list[tuple[int, bytes]] | None = None,
) -> bytes:
    """Entropy-encode quantized DCT coefficients into a full JPEG.

    ``coefs[i]``: (Hb_i, Wb_i, 64) int16 in natural order, the unpadded
    block grid. The quant tables are ``quality``'s, or ``qtables`` (luma
    and chroma, (64,) natural order) written as given: the lossless
    transforms need that, since their tables are transposed or not
    libjpeg's. ``markers``: (code, payload) records (:func:`read_markers`)
    written after the frame tables. MCU-edge dummy blocks are synthesized
    natively with the direct encoder's jccoefct.c semantics, so for
    matching coefficients the file is byte-identical to
    :func:`encode_bytes_opts` on the same pixels.
    """
    lib = _load()
    ncomps = len(coefs)
    sub_code = _SUB_CODES[subsampling]
    arrays = [np.ascontiguousarray(a, dtype=np.int16) for a in coefs]
    # A mis-shaped array would be an out-of-bounds read in C.
    for i, (a, (hb, wb)) in enumerate(
            zip(arrays, _coef_block_shapes(width, height, ncomps, subsampling))):
        if a.shape != (hb, wb, 64):
            raise ValueError(f"component {i} coefficients have shape {a.shape}, expected "
                             f"({hb}, {wb}, 64) for {width}x{height} "
                             f"subsampling={subsampling!r}")
    i16p = ctypes.POINTER(ctypes.c_int16)
    ptrs = (i16p * ncomps)(*[a.ctypes.data_as(i16p) for a in arrays])
    _qt_keep, qt_ptr = _qt_ptr(qtables)
    mk_ptr, mk_len = None, 0
    if markers:
        mk_buf = np.frombuffer(b"".join(
            int(code).to_bytes(4, "little") + len(payload).to_bytes(4, "little")
            + bytes(payload) for code, payload in markers), dtype=np.uint8)
        mk_ptr, mk_len = _as_u8p(mk_buf), mk_buf.size
    return _run_encode(
        lambda out, cap, out_len: lib.hipe_jpeg_write_coefs(
            width, height, ncomps, quality, sub_code, int(progressive), int(arithmetic),
            int(restart_interval), int(optimize), qt_ptr, mk_ptr, mk_len, ptrs, out, cap,
            out_len),
        width * height * 3 + 65536)


# ---- Batched entropy coding (the serving path) ----
#
# GIL-free pthread pools on the C side: two ctypes calls a batch instead of
# 2 * B, and the Huffman work runs in parallel.


def _batch_ptrs(datas: list[bytes]):
    """(keepalive buffers, u8 pointer array, length array) for payloads."""
    bufs = [np.frombuffer(d, dtype=np.uint8) for d in datas]
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    ptrs = (u8p * len(bufs))(*[_as_u8p(b) for b in bufs])
    lens = (ctypes.c_size_t * len(bufs))(*[b.size for b in bufs])
    return bufs, ptrs, lens


def read_coefficients_batch(datas: list[bytes],
                            num_threads: int | None = None) -> list[JpegCoefficients]:
    """``[read_coefficients(d) for d in datas]`` on the native thread pool.

    One header pass sizes the buffers, one read pass fills them. Raises
    with the failing indices if any payload is corrupt.
    """
    if not datas:
        return []
    lib = _load()
    n = len(datas)
    _keep, ptrs, lens = _batch_ptrs(datas)
    nt = num_threads or (os.cpu_count() or 1)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    infos = np.zeros((n, _INFO_LEN), dtype=np.intc)
    rcs = np.zeros(n, dtype=np.intc)
    fails = lib.hipe_jpeg_coef_info_batch(ptrs, lens, n, infos.ctypes.data_as(c_int_p),
                                          rcs.ctypes.data_as(c_int_p), nt)
    if fails:
        raise ValueError(f"{fails} payloads failed JPEG coefficient scan "
                         f"(indices {np.nonzero(rcs)[0].tolist()})")
    i16p = ctypes.POINTER(ctypes.c_int16)
    ptr_table = (i16p * (n * 4))()
    arrays: list[list[np.ndarray]] = []
    for i in range(n):
        arrs = []
        for ci in range(int(infos[i, 0])):
            _, _, wb, hb, _ = (int(x) for x in infos[i, 6 + 5 * ci: 11 + 5 * ci])
            a = np.empty((hb, wb, 64), dtype=np.int16)
            arrs.append(a)
            ptr_table[i * 4 + ci] = a.ctypes.data_as(i16p)
        arrays.append(arrs)
    qtabs = np.zeros((n, 4, 64), dtype=np.uint16)
    rcs2 = np.zeros(n, dtype=np.intc)
    fails = lib.hipe_jpeg_read_coefs_batch(
        ptrs, lens, n, ptr_table, qtabs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rcs2.ctypes.data_as(c_int_p), nt)
    if fails:
        raise ValueError(f"{fails} payloads failed JPEG coefficient decode "
                         f"(indices {np.nonzero(rcs2)[0].tolist()})")
    out = []
    for i in range(n):
        info = infos[i]
        comps = []
        for ci in range(int(info[0])):
            h_samp, v_samp, _, _, qno = (int(x) for x in info[6 + 5 * ci: 11 + 5 * ci])
            comps.append(ComponentCoefs(coefs=arrays[i][ci], qtable=qtabs[i, qno].copy(),
                                        h_samp=h_samp, v_samp=v_samp))
        out.append(JpegCoefficients(
            width=int(info[1]), height=int(info[2]), components=comps,
            max_h=int(info[3]), max_v=int(info[4]), progressive=bool(info[5]),
            color_space=int(info[26])))
    return out


def write_coefficients_batch(
    coefs: list[np.ndarray],
    width: int,
    height: int,
    quality: int = 90,
    subsampling: str = "420",
    progressive: bool = False,
    arithmetic: bool = False,
    restart_interval: int = 0,
    optimize: bool = False,
    qtables: list[np.ndarray] | None = None,
    num_threads: int | None = None,
) -> list[bytes]:
    """Entropy-encode a coefficient batch into JPEG files concurrently.

    ``coefs[ci]``: (B, Hb_ci, Wb_ci, 64) int16, one stacked batch a
    component (the device encoder's layout); B :func:`write_coefficients`
    calls on the native thread pool, with ``qtables`` as there. An image whose stream exceeds its
    preallocated slot is redone at the exact size the C side reports.
    """
    lib = _load()
    ncomps = len(coefs)
    sub_code = _SUB_CODES[subsampling]
    arrays = [np.ascontiguousarray(a, dtype=np.int16) for a in coefs]
    b = arrays[0].shape[0]
    for ci, (a, (hb, wb)) in enumerate(
            zip(arrays, _coef_block_shapes(width, height, ncomps, subsampling))):
        if a.shape != (b, hb, wb, 64):
            raise ValueError(f"component {ci} coefficients have shape {a.shape}, expected "
                             f"({b}, {hb}, {wb}, 64) for {width}x{height} "
                             f"subsampling={subsampling!r}")
    i16p = ctypes.POINTER(ctypes.c_int16)
    # Image i of component ci starts at base + i * stride: the B * 4 pointer
    # table is address arithmetic in numpy.
    addrs = np.zeros(b * 4, dtype=np.uintp)
    for ci in range(ncomps):
        a = arrays[ci]
        addrs[ci::4] = a.ctypes.data + np.arange(b, dtype=np.uintp) * a.strides[0]
    ptr_table = ctypes.cast(addrs.ctypes.data, ctypes.POINTER(i16p))
    cap = width * height + 65536  # ~1 byte a pixel; overflows are redone below
    out = np.empty((b, cap), dtype=np.uint8)
    out_lens = np.zeros(b, dtype=np.uintp)
    rcs = np.zeros(b, dtype=np.intc)
    nt = num_threads or (os.cpu_count() or 1)
    _qt_keep, qt_ptr = _qt_ptr(qtables)
    lib.hipe_jpeg_write_coefs_batch(
        width, height, ncomps, quality, sub_code, int(progressive), int(arithmetic),
        int(restart_interval), int(optimize), qt_ptr, ptr_table, b, _as_u8p(out), cap,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nt)
    results: list[bytes] = []
    for i in range(b):
        rc = int(rcs[i])
        if rc == 0:
            results.append(out[i, : int(out_lens[i])].tobytes())
        elif rc == 3:
            results.append(write_coefficients(
                [arrays[ci][i] for ci in range(ncomps)], width, height, quality=quality,
                subsampling=subsampling, progressive=progressive, arithmetic=arithmetic,
                restart_interval=restart_interval, optimize=optimize, qtables=qtables))
        else:
            raise ValueError(f"JPEG coefficient write failed for image {i} (rc={rc})")
    return results
