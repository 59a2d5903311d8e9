"""Lossless DCT-domain JPEG transforms, the jpegtran analog
(``hipe_tpu.ops.jpeg_transform`` in torch).

jpegtran (transupp.c) rotates and flips a JPEG without decoding it: the
coefficient blocks move on the block grid and change inside each 8x8 by the
DCT's symmetries, so nothing is rounded. For a block B[u, v] of samples
b[y, x]:

- mirror horizontally (x -> 7-x): B[u, v] -> (-1)^v B[u, v];
- mirror vertically (y -> 7-y): B[u, v] -> (-1)^u B[u, v];
- transpose (x <-> y): B[u, v] -> B[v, u].

Those are tensor ops: block-grid reversals, sign masks and 8x8 transposes,
run on the card (``device``, default ``cuda``), batched over images, as
``hipe_tpu`` runs them under ``jax.jit``.

As jpegtran's ``-perfect``, a flip is lossless only when the flipped axis is
a whole number of iMCUs (dim % (8 * samp) == 0): else the hidden edge
samples would have to enter the image. Transpose always is; the rotations
inherit the flips' rules on their axes. Other geometries raise. "Lossless"
means coefficient-exact, as for jpegtran: the integer decode of a
transformed stream may differ by one from the transform of the original's
decode, since the islow IDCT's descales are not odd-symmetric.

The transpose-family ops transpose each quant table with its coefficients,
and :func:`transform_bytes` writes those tables through
``write_coefficients(qtables=...)``: without them the bytes would change.
``grayscale`` (jpegtran ``-grayscale``) drops the chroma and keeps the luma
as it is; the crop (:func:`crop_coefficients`) is host numpy, as in
``hipe_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from hipe_tpu_torch.io_ import jpeg as jio

# The DCT-domain tensor transforms (a component's coefficient ops).
OPS = ("flip_h", "flip_v", "rot90", "rot180", "rot270", "transpose", "transverse")
# What transform_bytes/transform_batch take: the tensor ops and the
# component drop.
ALL_OPS = OPS + ("grayscale",)

_SIGN = torch.tensor([(-1) ** v for v in range(8)], dtype=torch.int16)


def _blocks(c: torch.Tensor) -> torch.Tensor:
    return c.reshape(*c.shape[:-1], 8, 8)


def _flat(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(*b.shape[:-2], 64)


def _flip_h(c: torch.Tensor) -> torch.Tensor:
    """Mirror horizontally: reverse the block columns, negate odd-v coefficients."""
    return _flat(_blocks(c).flip(-3) * _SIGN.to(c.device))


def _flip_v(c: torch.Tensor) -> torch.Tensor:
    """Mirror vertically: reverse the block rows, negate odd-u coefficients."""
    return _flat(_blocks(c).flip(-4) * _SIGN.to(c.device)[:, None])


def _transpose(c: torch.Tensor) -> torch.Tensor:
    """Transpose: swap the block grid's axes and each 8x8's u and v."""
    return _flat(_blocks(c).transpose(-4, -3).transpose(-2, -1))


def transform_component(c: torch.Tensor, op: str) -> torch.Tensor:
    """One lossless op on a (..., Hb, Wb, 64) int16 coefficient grid."""
    if op == "flip_h":
        return _flip_h(c)
    if op == "flip_v":
        return _flip_v(c)
    if op == "transpose":
        return _transpose(c)
    if op == "rot90":  # clockwise: transpose, then mirror horizontally
        return _flip_h(_transpose(c))
    if op == "rot270":  # counter-clockwise
        return _flip_v(_transpose(c))
    if op == "rot180":
        return _flip_v(_flip_h(c))
    if op == "transverse":  # transpose across the anti-diagonal
        return _flip_v(_flip_h(_transpose(c)))
    raise ValueError(f"unknown transform {op!r} (one of {OPS})")


def _device(device) -> torch.device:
    """``device`` (default ``cuda``); raises where CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False: "
                           "the transforms run on an NVIDIA GPU unless device='cpu' is given")
    return dev


def _on(coefs: np.ndarray, op: str, dev: torch.device) -> np.ndarray:
    """``op`` on a numpy coefficient grid, run on ``dev``."""
    return transform_component(torch.from_numpy(coefs).to(dev), op).cpu().numpy()


def _swaps_axes(op: str) -> bool:
    return op in ("rot90", "rot270", "transpose", "transverse")


def _check_perfect(co, op: str) -> None:
    """Raise unless ``op`` is lossless for this stream (jpegtran -perfect)."""
    max_h = max(c.h_samp for c in co.components)
    max_v = max(c.v_samp for c in co.components)
    w_ok = co.width % (8 * max_h) == 0
    h_ok = co.height % (8 * max_v) == 0
    need = {
        "flip_h": w_ok, "flip_v": h_ok, "rot180": w_ok and h_ok,
        # After the transpose, the flipped axis is the original h or v.
        "rot90": h_ok, "rot270": w_ok, "transverse": w_ok and h_ok,
        "transpose": True,
    }[op]
    if not need:
        raise ValueError(
            f"{op} is not lossless for {co.width}x{co.height} at sampling "
            f"{max_h}x{max_v}: the trailing partial iMCU cannot re-enter "
            f"the image without recompression (jpegtran -perfect rule)")


_SAMP_NAMES = {
    ((2, 2), (1, 1), (1, 1)): "420",
    ((1, 1), (1, 1), (1, 1)): "444",
    ((2, 1), (1, 1), (1, 1)): "422",
    ((1, 2), (1, 1), (1, 1)): "440",
    ((4, 1), (1, 1), (1, 1)): "411",
    ((4, 2), (1, 1), (1, 1)): "410",
    ((3, 1), (1, 1), (1, 1)): "311",
    ((2, 2), (2, 1), (1, 1)): "asym",
}


def _subsampling_name(samp: list, ncomps: int) -> str:
    """The writer's layout name for a per-component sampling list."""
    if ncomps == 1:
        return "444"
    key = tuple(samp)
    if key not in _SAMP_NAMES:
        raise ValueError(f"no writer layout for sampling {samp}")
    return _SAMP_NAMES[key]


def _swapped_pieces(components, width: int, height: int, op: str):
    """(w, h, samp, qtables) after ``op``'s axis swap, if it swaps."""
    qtables = [np.asarray(c.qtable, dtype=np.uint16) for c in components]
    if _swaps_axes(op):
        return (height, width, [(c.v_samp, c.h_samp) for c in components],
                [q.reshape(8, 8).T.reshape(64).copy() for q in qtables])
    return width, height, [(c.h_samp, c.v_samp) for c in components], qtables


def _grayscale_luma(co) -> np.ndarray:
    """jpegtran -grayscale's luma: component 0 as it is, trimmed to a
    1-component stream's block grid (its iMCU is one block, so the colour
    stream's padding blocks, which hold no image, go)."""
    comp0 = co.components[0]
    if (comp0.h_samp, comp0.v_samp) != (co.max_h, co.max_v):
        raise ValueError(
            "grayscale keep needs full-resolution luma (component 0 must "
            f"carry max sampling; got {comp0.h_samp}x{comp0.v_samp} of "
            f"{co.max_h}x{co.max_v})")
    hb, wb = -(-co.height // 8), -(-co.width // 8)
    return np.ascontiguousarray(comp0.coefs[:hb, :wb]).astype(np.int16)


def transform_coefficients(co, op: str, device=None):
    """Losslessly transform a :class:`hipe_tpu_torch.io_.jpeg.JpegCoefficients`
    into the writer's pieces: (coefficient arrays, width, height, each
    component's (h_samp, v_samp), quant tables), after any axis swap, the
    tables transposed with the coefficients for the transpose-family ops
    (the symmetry acts on C[u, v] * Q[u, v]; transupp.c does the same).
    The tensor ops run on ``device`` (default ``cuda``)."""
    if op == "grayscale":
        return ([_grayscale_luma(co)], co.width, co.height, [(1, 1)],
                [co.components[0].qtable])
    _check_perfect(co, op)
    dev = _device(device)
    out = [_on(comp.coefs, op, dev) for comp in co.components]
    w, h, samp, qtables = _swapped_pieces(co.components, co.width, co.height, op)
    return out, w, h, samp, qtables


def transform_bytes(data: bytes, op: str, copy_markers: bool = True, device=None,
                    **writer_opts) -> bytes:
    """jpegtran analog: losslessly transform a JPEG byte stream.

    The host entropy-decodes, the card transforms, the host entropy-encodes
    with the stream's own quant tables (transposed for the transpose-family
    ops): nothing is requantized. The writer's entropy options
    (progressive, arithmetic, optimize, restart_interval) pass through.
    ``copy_markers`` (jpegtran ``-copy all``) carries the COM and APP1-13
    markers (Exif, ICC, XMP) over verbatim, spatial tags in them included.
    """
    co = jio.read_coefficients(data)
    if copy_markers:
        writer_opts.setdefault("markers", jio.read_markers(data))
    coefs, w, h, samp, qtables = transform_coefficients(co, op, device)
    return jio.write_coefficients(coefs, w, h, subsampling=_subsampling_name(samp, len(coefs)),
                                  qtables=qtables, **writer_opts)


def _has_metadata(data: bytes) -> bool:
    """Whether a COM or APP1-13 marker comes before SOS: a walk of the
    segment headers, so the batch reads markers only where there are some."""
    p = 2  # past SOI
    n = len(data)
    while p + 4 <= n:
        if data[p] != 0xFF:
            return False  # not a well-formed segment stream
        # 0xFF fill bytes may pad before the marker code.
        while p + 4 <= n and data[p + 1] == 0xFF:
            p += 1
        if p + 4 > n:
            return False
        code = data[p + 1]
        if code == 0xDA:  # SOS: entropy data follows
            return False
        if code == 0xFE or 0xE1 <= code <= 0xED:
            return True
        p += 2 + ((data[p + 2] << 8) | data[p + 3])
    return False


def transform_batch(payloads: list[bytes], op: str, num_threads: int | None = None,
                    copy_markers: bool = True, device=None, **writer_opts) -> list[bytes]:
    """:func:`transform_bytes` over a batch: the native batch reader, one
    tensor op a (geometry, quant tables) group on the stacked grids, the
    native batch writer (the single writer for images that carry markers,
    which are per image)."""
    cos = jio.read_coefficients_batch(payloads, num_threads=num_threads)
    groups: dict[tuple, list[int]] = {}
    for i, co in enumerate(cos):
        key = (co.width, co.height, tuple((c.h_samp, c.v_samp) for c in co.components),
               tuple(tuple(int(v) for v in c.qtable) for c in co.components))
        groups.setdefault(key, []).append(i)
    dev = None if op == "grayscale" else _device(device)
    out: list[bytes | None] = [None] * len(cos)
    for idxs in groups.values():
        rep = cos[idxs[0]]
        if op == "grayscale":
            transformed = [np.stack([_grayscale_luma(cos[i]) for i in idxs])]
            w, h, samp, qtables = rep.width, rep.height, [(1, 1)], [rep.components[0].qtable]
        else:
            _check_perfect(rep, op)
            transformed = [_on(np.stack([cos[i].components[ci].coefs for i in idxs]), op, dev)
                           for ci in range(len(rep.components))]
            w, h, samp, qtables = _swapped_pieces(rep.components, rep.width, rep.height, op)
        sub = _subsampling_name(samp, len(transformed))
        markers = [jio.read_markers(payloads[i]) if copy_markers and _has_metadata(payloads[i])
                   else [] for i in idxs]
        if any(markers):
            files = [jio.write_coefficients([t[j] for t in transformed], w, h, subsampling=sub,
                                            qtables=qtables, markers=markers[j], **writer_opts)
                     for j in range(len(idxs))]
        else:
            files = jio.write_coefficients_batch(transformed, w, h, subsampling=sub,
                                                 qtables=qtables, num_threads=num_threads,
                                                 **writer_opts)
        for j, i in enumerate(idxs):
            out[i] = files[j]
    return out


def crop_coefficients(co, x: int, y: int, w: int, h: int):
    """Lossless crop (jpegtran -crop): slices of the block grids, host numpy.

    (x, y) must be iMCU-aligned (multiples of 8*max_h and 8*max_v), since the
    entropy stream cannot start inside an iMCU; w and h are clipped at the
    image's edges. Returns :func:`transform_coefficients`' pieces, sampling
    and tables unchanged. Every component's samples inside the crop decode
    from the same blocks; in subsampled streams the chroma upsampler
    replicates at the new edges, so the one-pixel edge ring can differ, as
    with jpegtran.
    """
    imcu_w, imcu_h = 8 * co.max_h, 8 * co.max_v
    if x % imcu_w or y % imcu_h:
        raise ValueError(f"crop origin ({x}, {y}) must be iMCU-aligned "
                         f"(multiples of {imcu_w}x{imcu_h} for this stream)")
    if not (0 <= x < co.width and 0 <= y < co.height):
        raise ValueError(f"crop origin ({x}, {y}) outside {co.width}x{co.height}")
    if w <= 0 or h <= 0:
        raise ValueError("crop size must be positive")
    w = min(w, co.width - x)
    h = min(h, co.height - y)
    out, samp, qtables = [], [], []
    for comp in co.components:
        bx0 = x * comp.h_samp // (8 * co.max_h)
        by0 = y * comp.v_samp // (8 * co.max_v)
        dw = -(-w * comp.h_samp // co.max_h)
        dh = -(-h * comp.v_samp // co.max_v)
        wb, hb = -(-dw // 8), -(-dh // 8)
        out.append(np.ascontiguousarray(comp.coefs[by0:by0 + hb, bx0:bx0 + wb]))
        samp.append((comp.h_samp, comp.v_samp))
        qtables.append(np.asarray(comp.qtable, dtype=np.uint16))
    return out, w, h, samp, qtables


def crop_bytes(data: bytes, x: int, y: int, w: int, h: int, copy_markers: bool = True,
               **writer_opts) -> bytes:
    """jpegtran -crop analog: a region without recompression."""
    co = jio.read_coefficients(data)
    if copy_markers:
        writer_opts.setdefault("markers", jio.read_markers(data))
    coefs, w, h, samp, qtables = crop_coefficients(co, x, y, w, h)
    return jio.write_coefficients(coefs, w, h,
                                  subsampling=_subsampling_name(samp, len(co.components)),
                                  qtables=qtables, **writer_opts)
