"""Global-statistics point operations (counterpart of ``hipe_tpu.ops.equalize``).

Every other stage of the port is a local stencil or a codec transform; these
ops are driven by whole-image statistics or cross-channel blends, each PIL
bit for bit:

- ``equalize``: PIL ``ImageOps.equalize``. A 256-bin histogram a plane, a
  monotone LUT in integer floor division, a gather.
- ``autocontrast``: PIL ``ImageOps.autocontrast`` with ``cutoff`` (integer
  percents trimmed from each histogram end) and ``preserve_tone`` (one
  Pillow-luma range an image). PIL computes the stretch in float64, which
  differs from the exact rational form (lo=26, hi=33 maps 33 to 254), so
  the LUT of every (lo, hi) pair is built once on the host in float64 (a
  256^3 uint8 cube, 16 MB, cached a device) and the device only gathers
  the row its min/max pick.
- ``contrast``: PIL ``ImageEnhance.Contrast``. The rounded mean of the
  Pillow luma an image, then a row of a (mean, value) table built on the
  host in float32 for the factor.
- ``color``: PIL ``ImageEnhance.Color``, a blend a pixel with its own luma.
  PIL rounds the float32 product ``factor * (c - l)`` before it adds ``l``;
  a fused multiply-add would skip that rounding, so the 511 products are a
  host table and the device computes only the float32 add and ``trunc``.
- ``sharpness``: PIL ``ImageEnhance.Sharpness``, the same blend against the
  image through PIL's SMOOTH kernel, with PIL's border copy. The SMOOTH
  plane is the port's ``pil_smooth`` stage through ``ops/planar.py``:
  on the card kernel K3 (K5 for planes too wide for it), on the CPU the
  plain chain.
- ``mode`` / ``mode5``: PIL ``ImageFilter.ModeFilter(3 | 5)``. The window
  is truncated at the image bounds, ties break to the lowest value and a
  mode seen at most twice leaves the pixel. On the card kernel K12
  (``ops/cuda_mode.py``): a sliding 256-bin histogram a thread, one launch
  a call. On the CPU the plain form: a -1 sentinel, kept in int16, marks
  the positions outside, and counts come from a pairwise equality sum.

Each op has ``_planar`` (``(N, H, W)``; the per-image ops group planes as
``b*channels + c``), ``_rows`` (``(B, H, W*C)``) and ``_nhwc`` (``(..., H,
W, C)``) forms, and a NumPy ``_oracle``. Histograms are ``scatter_add_``
over the values as int64 indices, exact whatever order the atomics take; a
LUT is applied with ``torch.gather``. ``hipe_tpu``'s comparison-sum LUT apply
(``use_cmp``) is a TPU formulation and is not carried over. The planar ops
take ``out=``. They materialize int64 indices and int32/int16 temporaries
the size of their input, so callers at stream scale chunk them
(``GlobalStatsPipeline`` does). Equalize and the mode filters on a CUDA
tensor are the exceptions: equalize's three stages are the hand-written
kernels K8-K10 (``ops/cuda_equalize.py``), with about 1.3 KB of
temporaries a plane, and the mode filter is kernel K12
(``ops/cuda_mode.py``), with none; neither is chunked.
``equalize_planar``'s three stages are the spans ``stats.histogram``,
``stats.lut`` and ``stats.apply`` (``profiling/trace.py``), one of each a
call, on either route; the whole of ``mode_planar`` (either size) is the
span ``stats.mode``, one a call.

``colorize_lut`` builds PIL ``ImageOps.colorize``'s three wedge tables with
Pillow's own integer arithmetic; the serving pipeline applies them as the
mirror of its grayscale output. Colours are RGB triples, ``#rgb`` or
``#rrggbb``; other colour strings (names such as ``"navy"``) are parsed by
PIL's ``ImageColor``, which is needed for those alone.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import torch

from hipe_tpu_torch.ops.planar import filter_planar
from hipe_tpu_torch.ops.reference import kernel_oracle
from hipe_tpu_torch.profiling.trace import span

_HEX = re.compile(r"#(?:[0-9a-f]{3}|[0-9a-f]{6})")


def _rgb(color) -> tuple[int, int, int]:
    """An RGB triple from a triple, ``#rgb``, ``#rrggbb`` or (through PIL)
    any other colour string PIL's ``ImageColor`` parses."""
    if not isinstance(color, str):
        return tuple(int(v) for v in color)[:3]
    text = color.lower()
    if _HEX.fullmatch(text):
        digits = text[1:] if len(text) == 7 else "".join(ch * 2 for ch in text[1:])
        return tuple(int(digits[i:i + 2], 16) for i in (0, 2, 4))
    try:
        from PIL import ImageColor
    except ImportError as e:
        raise ValueError(f"colour {color!r}: colour names need PIL's ImageColor, which is "
                         "not installed; give an RGB triple, #rgb or #rrggbb") from e
    return ImageColor.getrgb(color)[:3]


def colorize_lut(black, white, mid=None, blackpoint: int = 0, whitepoint: int = 255,
                 midpoint: int = 127) -> np.ndarray:
    """(3, 256) uint8 wedge tables: PIL ``ImageOps.colorize`` bit for bit."""
    kb, kw = _rgb(black), _rgb(white)
    km = _rgb(mid) if mid is not None else None
    if km is None:
        if not 0 <= blackpoint <= whitepoint <= 255:
            raise ValueError(f"need 0 <= blackpoint <= whitepoint <= 255, got "
                             f"{blackpoint}/{whitepoint}")
    elif not 0 <= blackpoint <= midpoint <= whitepoint <= 255:
        raise ValueError(f"need 0 <= blackpoint <= midpoint <= whitepoint <= 255, got "
                         f"{blackpoint}/{midpoint}/{whitepoint}")
    lut = np.empty((3, 256), np.int64)
    for ch in range(3):
        vals = [kb[ch]] * blackpoint
        if km is None:
            n = whitepoint - blackpoint
            vals += [kb[ch] + i * (kw[ch] - kb[ch]) // n for i in range(n)]
        else:
            n1 = midpoint - blackpoint
            vals += [kb[ch] + i * (km[ch] - kb[ch]) // n1 for i in range(n1)]
            n2 = whitepoint - midpoint
            vals += [km[ch] + i * (kw[ch] - km[ch]) // n2 for i in range(n2)]
        vals += [kw[ch]] * (256 - whitepoint)
        lut[ch] = vals
    return lut.astype(np.uint8)


def colorize_oracle(gray: np.ndarray, lut3: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3) through the three wedge tables."""
    return np.stack([lut3[c][gray] for c in range(3)], axis=-1)



# ---- host tables, cached once a device ----


@functools.lru_cache(maxsize=64)
def _device_table(make, arg, device: torch.device) -> torch.Tensor:
    """``make(arg)`` (or ``make()``), a host table, as a tensor on ``device``,
    made once a process and device. On the card the copy is waited for, so
    any stream may read the table."""
    tab = torch.from_numpy(make() if arg is None else make(arg)).to(device)
    if tab.device.type == "cuda":
        torch.cuda.current_stream(tab.device).synchronize()
    return tab


@functools.lru_cache(maxsize=1)
def _autocontrast_table() -> np.ndarray:
    """(256, 256, 256) uint8: table[lo, hi] is PIL's float64 LUT."""
    ix = np.arange(256, dtype=np.float64)
    tab = np.empty((256, 256, 256), np.uint8)
    ident = np.arange(256, dtype=np.uint8)
    for lo in range(256):
        tab[lo] = ident  # hi <= lo rows: identity ("don't bother")
        his = np.arange(lo + 1, 256)
        if his.size == 0:
            continue
        scale = 255.0 / (his - lo)
        offset = -lo * scale
        # int() truncates toward zero (negatives clip to 0 anyway).
        vals = np.trunc(ix[None, :] * scale[:, None] + offset[:, None])
        tab[lo, his] = np.clip(vals, 0, 255).astype(np.uint8)
    return tab


@functools.lru_cache(maxsize=16)
def _contrast_table(factor: float) -> np.ndarray:
    """(256, 256) uint8: table[mean, v] = PIL blend(mean, v, factor)."""
    m = np.arange(256, dtype=np.float32)[:, None]
    v = np.arange(256, dtype=np.float32)[None, :]
    t = (np.float32(factor) * (v - m)).astype(np.float32)
    vals = np.trunc((m + t).astype(np.float32))
    return np.clip(vals, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=16)
def _color_product_table(factor: float) -> np.ndarray:
    """(511,) fp32: the PIL-rounded products factor*d for d in [-255, 255]."""
    d = np.arange(-255, 256, dtype=np.float32)
    return (np.float32(factor) * d).astype(np.float32)


# ---- layouts ----


def _rows_via_planar(planar_fn, rows: torch.Tensor, channels: int, **kw) -> torch.Tensor:
    """(B, H, W*C) rows -> per-channel planes -> planar_fn(planes, channels)
    -> rows."""
    b, h, lane = rows.shape
    if channels < 1 or lane % channels:
        raise ValueError(f"row length {lane} is not a multiple of {channels} channels")
    w = lane // channels
    planes = rows.reshape(b, h, w, channels).permute(0, 3, 1, 2).reshape(b * channels, h, w)
    out = planar_fn(planes, channels, **kw)
    return out.view(b, channels, h, w).permute(0, 2, 3, 1).reshape(b, h, lane)


def _nhwc_via_rows(rows_fn, x: torch.Tensor, **kw) -> torch.Tensor:
    """(..., H, W, C) -> rows_fn on (B, H, W*C) -> the same shape; no
    leading axis is one image."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    b = int(np.prod(lead, dtype=np.int64)) if lead else 1
    out = rows_fn(x.reshape(b, h, w * c), c, **kw)
    return out.reshape(*lead, h, w, c)


def _groups(planes: torch.Tensor, channels: int) -> int:
    """Images in planar ``(B*C, H, W)``, or ValueError."""
    if channels < 1 or planes.shape[0] % channels:
        raise ValueError(f"{planes.shape[0]} planes are not whole images of "
                         f"{channels} channels")
    return planes.shape[0] // channels


def _store(res: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """``res`` (any dtype the store truncates exactly) as uint8, in ``out`` if given."""
    if out is None:
        return res.to(torch.uint8)
    return out.copy_(res)


def _apply_lut(lut: torch.Tensor, idx: torch.Tensor, shape, out) -> torch.Tensor:
    """out[g, p] = lut[g, idx[g, p]] for (G, P) int64 ``idx``, returned in
    ``shape``; written straight into a contiguous ``out``."""
    if out is not None and out.is_contiguous():
        torch.gather(lut, 1, idx, out=out.view(idx.shape))
        return out
    return _store(torch.gather(lut, 1, idx).view(shape), out)


# ---- equalize ----


def _histogram(idx: torch.Tensor) -> torch.Tensor:
    """(N, P) int64 values in [0, 256) -> (N, 256) int32 counts."""
    hist = torch.zeros((idx.shape[0], 256), dtype=torch.int32, device=idx.device)
    ones = torch.ones((), dtype=torch.int32, device=idx.device).expand(idx.shape)
    return hist.scatter_add_(1, idx, ones)


def histogram_planes(planes: torch.Tensor) -> torch.Tensor:
    """Per-plane 256-bin histograms: (N, H, W) uint8 -> (N, 256) int32."""
    return _histogram(planes.reshape(planes.shape[0], -1).long())


def equalize_lut(hist: torch.Tensor, npix: int) -> torch.Tensor:
    """PIL ``ImageOps.equalize`` LUTs from (..., 256) histograms summing to
    ``npix``: (..., 256) uint8, integer arithmetic only."""
    h = hist.long()
    idx = torch.arange(256, device=h.device)
    csum_excl = h.cumsum(-1) - h
    nonzero = h > 0
    last_idx = torch.where(nonzero, idx, -1).amax(-1)
    last_count = h.gather(-1, last_idx.clamp(min=0)[..., None])[..., 0]
    num_nonzero = nonzero.sum(-1)
    step = (npix - last_count) // 255
    safe = step.clamp(min=1)[..., None]
    # PIL clamps LUT entries at 255 (past the last populated bin they can
    # exceed it).
    lut_eq = ((safe // 2 + csum_excl) // safe).clamp(0, 255)
    use_ident = (num_nonzero <= 1) | (step <= 0)
    return torch.where(use_ident[..., None], idx.expand_as(lut_eq), lut_eq).to(torch.uint8)


def apply_lut(planes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Gather formulation: out[n, p] = lut[n, planes[n, p]]."""
    return _apply_lut(lut, planes.reshape(planes.shape[0], -1).long(), planes.shape, None)


def _equalize_planar_cuda(planes: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """Equalize on the card: kernels K8, K9 and K10, one launch each over all
    the planes (``ops/cuda_equalize.py``), no int64 index."""
    from hipe_tpu_torch.ops import cuda_equalize as ce

    _, h, w = planes.shape
    planes = planes.contiguous()
    with span("stats.histogram", planes.device):
        hist = ce.histogram_planes_cuda(planes)
    with span("stats.lut", planes.device):
        lut = ce.equalize_lut_cuda(hist, h * w)
    with span("stats.apply", planes.device):
        if out is None or out.is_contiguous():
            return ce.apply_lut_planar_cuda(planes, lut, out=out)
        return _store(ce.apply_lut_planar_cuda(planes, lut), out)


def equalize_planar(planes: torch.Tensor, channels: int = 3, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W) uint8, each plane equalized alone
    (``channels`` is taken for the family's signature). On the card the
    three kernels of ``ops/cuda_equalize.py``; on the CPU the torch ops."""
    if planes.device.type == "cuda":
        return _equalize_planar_cuda(planes, out)
    n, h, w = planes.shape
    with span("stats.histogram", planes.device):
        idx = planes.reshape(n, -1).long()  # shared by the histogram and the gather
        hist = _histogram(idx)
    with span("stats.lut", planes.device):
        lut = equalize_lut(hist, h * w)
    with span("stats.apply", planes.device):
        return _apply_lut(lut, idx, planes.shape, out)


def equalize_rows(rows: torch.Tensor, channels: int) -> torch.Tensor:
    """Interleaved rows (B, H, W*C) uint8, per-channel equalization."""
    return _rows_via_planar(equalize_planar, rows, channels)


def equalize_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same shape, per-channel equalization."""
    return _nhwc_via_rows(equalize_rows, x)


# ---- autocontrast ----


def autocontrast_lut(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(N,) extrema -> (N, 256) uint8 PIL-exact LUTs, gathered on their
    device from the float64 cube."""
    tab = _device_table(_autocontrast_table, None, lo.device)
    return tab[lo.long(), hi.long()]


def _normalize_cutoff(cutoff) -> tuple[int, int]:
    c = cutoff if isinstance(cutoff, tuple) else (cutoff, cutoff)
    if (len(c) != 2 or not all(isinstance(v, int) for v in c)
            or c[0] < 0 or c[1] < 0 or c[0] + c[1] >= 100):
        raise ValueError(
            f"cutoff must be non-negative integer percent(s) summing "
            f"below 100, got {cutoff!r} (integer-only keeps the trim "
            "arithmetic exact — PIL's int(n*cutoff//100))"
        )
    return c[0], c[1]


def autocontrast_extrema(hist: torch.Tensor, cutoff: tuple[int, int]) -> tuple:
    """PIL's histogram trim: (lo, hi) bins after cutting cutoff% per end.

    PIL's destructive walk in closed form: after removing ``cut0 =
    n*c0//100`` pixels from the low end, ``h_lo[i] = clip(min(h[i],
    cumsum(h)[i] - cut0), 0)``; the high cut applies the same formula to the
    suffix sums of the trimmed histogram. lo/hi are the first/last nonzero
    bins of the result (lo=255, hi=0 when the cuts take everything: the
    identity row of the cube).
    """
    c0, c1 = cutoff
    h = hist.long()
    n = h.sum(-1, keepdim=True)
    h_lo = torch.minimum(h, h.cumsum(-1) - n * c0 // 100).clamp(min=0)
    suffix = h_lo.flip(-1).cumsum(-1).flip(-1)
    h_fin = torch.minimum(h_lo, suffix - n * c1 // 100).clamp(min=0)
    idx = torch.arange(256, device=h.device)
    nz = h_fin > 0
    return torch.where(nz, idx, 255).amin(-1), torch.where(nz, idx, 0).amax(-1)


def autocontrast_planar(planes: torch.Tensor, channels: int = 3, *, cutoff=0,
                        preserve_tone: bool = False,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H, W) uint8 -> same, contrast-stretched.

    ``cutoff``: integer percent (or (low, high) percents) trimmed from the
    histogram ends before picking the range; 0 takes the min/max with no
    histogram. ``preserve_tone=False`` stretches each plane alone
    (``channels`` unused); ``True`` takes one range an image from the Pillow
    luma and applies its LUT to every channel (planes grouped as
    ``b*channels + c``).
    """
    c0, c1 = _normalize_cutoff(cutoff)
    n, h, w = planes.shape
    if preserve_tone:
        b = _groups(planes, channels)
        src = pil_luma(planes.reshape(b, channels, h, w))
        grouped = planes.reshape(b, channels * h * w)
    else:
        src, grouped = planes, planes.reshape(n, h * w)
    idx = grouped.long()
    if c0 == 0 and c1 == 0:
        lo, hi = torch.aminmax(src.reshape(src.shape[0], -1), dim=1)
    else:
        # Per plane, the gather's index is the histogram's too.
        hist = histogram_planes(src) if preserve_tone else _histogram(idx)
        lo, hi = autocontrast_extrema(hist, (c0, c1))
    return _apply_lut(autocontrast_lut(lo, hi), idx, planes.shape, out)


def autocontrast_rows(rows: torch.Tensor, channels: int, *, cutoff=0,
                      preserve_tone: bool = False) -> torch.Tensor:
    """Interleaved rows (B, H, W*C) uint8 autocontrast."""
    return _rows_via_planar(autocontrast_planar, rows, channels, cutoff=cutoff,
                            preserve_tone=preserve_tone)


def autocontrast_nhwc(x: torch.Tensor, *, cutoff=0, preserve_tone: bool = False) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same shape autocontrast."""
    return _nhwc_via_rows(autocontrast_rows, x, cutoff=cutoff, preserve_tone=preserve_tone)


def autocontrast_oracle(img: np.ndarray, cutoff=0, preserve_tone: bool = False) -> np.ndarray:
    """NumPy reference of PIL autocontrast.

    PIL's literal destructive histogram walk (not the closed form the torch
    path uses). ``preserve_tone=True`` walks the Pillow-luma histogram once
    and applies its LUT to every channel.
    """
    c0, c1 = _normalize_cutoff(cutoff)
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    out = np.empty_like(img)
    if preserve_tone and img.shape[2] == 3:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        tone = ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)
        sources = [tone] * 3
    else:
        sources = [img[..., ci] for ci in range(img.shape[2])]
    for ci in range(img.shape[2]):
        chan = img[..., ci]
        h = np.bincount(sources[ci].ravel(), minlength=256).astype(np.int64)
        if c0 or c1:
            n = int(h.sum())
            cut = n * c0 // 100
            for lo_i in range(256):
                if cut > h[lo_i]:
                    cut -= h[lo_i]
                    h[lo_i] = 0
                else:
                    h[lo_i] -= cut
                    cut = 0
                if cut <= 0:
                    break
            cut = n * c1 // 100
            for hi_i in range(255, -1, -1):
                if cut > h[hi_i]:
                    cut -= h[hi_i]
                    h[hi_i] = 0
                else:
                    h[hi_i] -= cut
                    cut = 0
                if cut <= 0:
                    break
        nz = np.nonzero(h)[0]
        lo = int(nz[0]) if nz.size else 255
        hi = int(nz[-1]) if nz.size else 0
        if hi <= lo:
            lut = np.arange(256, dtype=np.uint8)
        else:
            scale = 255.0 / (hi - lo)
            offset = -lo * scale
            lut = np.clip(np.trunc(np.arange(256, dtype=np.float64) * scale + offset),
                          0, 255).astype(np.uint8)
        out[..., ci] = lut[chan]
    return out[..., 0] if squeeze else out


def equalize_oracle(img: np.ndarray) -> np.ndarray:
    """NumPy reference of PIL ``ImageOps.equalize`` a channel; (H, W) or
    (H, W, C) uint8."""
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    out = np.empty_like(img)
    npix = img.shape[0] * img.shape[1]
    for ci in range(img.shape[2]):
        chan = img[..., ci]
        h = np.bincount(chan.ravel(), minlength=256).astype(np.int64)
        nz = np.nonzero(h)[0]
        step = 0 if len(nz) == 0 else (npix - h[nz[-1]]) // 255
        if len(nz) <= 1 or step == 0:
            lut = np.arange(256, dtype=np.int64)
        else:
            lut = (step // 2 + (np.cumsum(h) - h)) // step
        out[..., ci] = np.clip(lut, 0, 255).astype(np.uint8)[chan]
    return out[..., 0] if squeeze else out


# ---- contrast ----


def contrast_lut(mean_i: torch.Tensor, factor: float) -> torch.Tensor:
    """(B,) rounded means -> (B, 256) uint8 PIL-exact LUTs."""
    return _device_table(_contrast_table, float(factor), mean_i.device)[mean_i.long()]


def pil_luma(img4: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) uint8 -> (B, H, W) uint8 Pillow ``convert("L")`` luma:
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16, exact in int32. C=1 is the
    identity."""
    c = img4.shape[1]
    if c == 1:
        return img4[:, 0]
    if c != 3:
        raise ValueError(f"contrast needs 1- or 3-channel images (PIL L / RGB), got C={c}")
    acc = img4[:, 0].to(torch.int32) * 19595
    acc += img4[:, 1].to(torch.int32) * 38470
    acc += img4[:, 2].to(torch.int32) * 7471
    acc += 0x8000
    return (acc >> 16).to(torch.uint8)


def luma_mean_round_half(hist: torch.Tensor, npix: int) -> torch.Tensor:
    """(B, 256) luma histograms -> (B,) int(S/npix + 0.5), exact.

    S = sum(v * h_v) as the sum over thresholds t of the pixels >= t, in
    three partial sums; the rounded mean is the floor of (2S + N) / (2N).
    ``hipe_tpu`` keeps every term in int32, which bounds an image at about
    12.6M pixels; the same bound raises here, so both packages take the
    same images.
    """
    if 170 * npix >= 2 ** 31:
        raise ValueError(
            f"contrast mean: image too large for exact int32 arithmetic "
            f"({npix} pixels; limit ~12.6M)"
        )
    ge = npix - hist.long().cumsum(-1)[:, :255]  # ge[:, t-1] = #pixels >= t
    n2 = 2 * npix
    parts = [ge[:, 0:85].sum(-1), ge[:, 85:170].sum(-1), ge[:, 170:255].sum(-1)]
    nums = [2 * parts[0], 2 * parts[1], 2 * parts[2] + npix]
    q = sum(n // n2 for n in nums)
    rem = sum(n % n2 for n in nums)
    return q + rem // n2


def contrast_planar(planes: torch.Tensor, channels: int = 3, *, factor: float = 1.0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """(B*C, H, W) uint8 (plane index b*C + c) -> same: one luma mean and
    one LUT an image, applied to every channel (PIL's degenerate gray)."""
    n, h, w = planes.shape
    b = _groups(planes, channels)
    luma = pil_luma(planes.reshape(b, channels, h, w))
    mean_i = luma_mean_round_half(histogram_planes(luma), h * w)
    lut = contrast_lut(mean_i, factor)
    return _apply_lut(lut, planes.reshape(b, channels * h * w).long(), planes.shape, out)


def contrast_rows(rows: torch.Tensor, channels: int, *, factor: float = 1.0) -> torch.Tensor:
    """Interleaved rows (B, H, W*C) uint8, per-image contrast."""
    return _rows_via_planar(contrast_planar, rows, channels, factor=factor)


def contrast_nhwc(x: torch.Tensor, *, factor: float = 1.0) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same shape, per-image contrast."""
    return _nhwc_via_rows(contrast_rows, x, factor=factor)


def contrast_oracle(img: np.ndarray, factor: float = 1.0) -> np.ndarray:
    """NumPy reference of PIL ``ImageEnhance.Contrast``, int64 statistics."""
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    h, w, c = img.shape
    if c == 1:
        luma = img[..., 0].astype(np.int64)
    else:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        luma = (19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16
    s = int(luma.sum())
    npix = h * w
    mean_i = (2 * s + npix) // (2 * npix)
    out = _contrast_table(float(factor))[mean_i][img]
    return out[..., 0] if squeeze else out


# ---- color ----


def _blend(base: torch.Tensor, diff: torch.Tensor, factor: float) -> torch.Tensor:
    """trunc(fp32(base + factor*diff)) clipped to [0, 255], float: the
    product from the host table (PIL's rounding), then one float32 add."""
    prod = _device_table(_color_product_table, float(factor), base.device)
    v = base.to(torch.float32) + prod[diff + 255]
    return v.trunc_().clamp_(0, 255)


def color_planar(planes: torch.Tensor, channels: int = 3, *, factor: float = 1.0,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(B*C, H, W) uint8 (plane index b*C + c) -> same, a blend a pixel with
    its own luma. One channel is the identity (PIL Color of an L image)."""
    n, h, w = planes.shape
    b = _groups(planes, channels)
    if channels == 1:
        return planes.clone() if out is None else out.copy_(planes)
    img4 = planes.reshape(b, channels, h, w)
    luma = pil_luma(img4).to(torch.int32)[:, None]
    res = _blend(luma, img4.to(torch.int32) - luma, factor)
    return _store(res.view(planes.shape), out)


def color_rows(rows: torch.Tensor, channels: int, *, factor: float = 1.0) -> torch.Tensor:
    """Interleaved rows (B, H, W*C) uint8, per-pixel saturation blend."""
    return _rows_via_planar(color_planar, rows, channels, factor=factor)


def color_nhwc(x: torch.Tensor, *, factor: float = 1.0) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same shape, per-pixel saturation blend."""
    return _nhwc_via_rows(color_rows, x, factor=factor)


def color_oracle(img: np.ndarray, factor: float = 1.0) -> np.ndarray:
    """NumPy fp32 reference of PIL ``ImageEnhance.Color``."""
    if img.ndim == 2 or img.shape[-1] == 1:
        return img.copy()
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    luma = ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16)
    lf = luma.astype(np.float32)[..., None]
    v = (lf + (np.float32(factor) * (img.astype(np.float32) - lf)).astype(np.float32)
         ).astype(np.float32)
    return np.clip(np.trunc(v), 0, 255).astype(np.uint8)


# ---- sharpness ----


def sharpness_planar(planes: torch.Tensor, channels: int = 3, *, factor: float = 1.0,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H, W) uint8 -> same; channel-independent, so any plane layout
    (``channels`` is taken for the family's signature). The SMOOTH plane is
    the ``pil_smooth`` stage's, on the kernel :func:`filter_planar` chooses."""
    smooth = filter_planar(planes, ("pil_smooth",)).to(torch.int32)
    res = _store(_blend(smooth, planes.to(torch.int32) - smooth, factor), out)
    # PIL's kernel filter copies the border through, so the blend there is x.
    res[:, 0] = planes[:, 0]
    res[:, -1] = planes[:, -1]
    res[:, :, 0] = planes[:, :, 0]
    res[:, :, -1] = planes[:, :, -1]
    return res


def sharpness_rows(rows: torch.Tensor, channels: int, *, factor: float = 1.0) -> torch.Tensor:
    """Interleaved rows (B, H, W*C) uint8, per-channel sharpness."""
    return _rows_via_planar(sharpness_planar, rows, channels, factor=factor)


def sharpness_nhwc(x: torch.Tensor, *, factor: float = 1.0) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same shape, PIL sharpness."""
    return _nhwc_via_rows(sharpness_rows, x, factor=factor)


def sharpness_oracle(img: np.ndarray, factor: float = 1.0) -> np.ndarray:
    """NumPy reference of PIL ``ImageEnhance.Sharpness``."""
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    sm = kernel_oracle(img, (1, 1, 1, 1, 5, 1, 1, 1, 1), 13, 0).astype(np.int64)
    d = img.astype(np.int64) - sm
    t = _color_product_table(float(factor))[d + 255]
    v = (sm.astype(np.float32) + t).astype(np.float32)
    out = np.clip(np.trunc(v), 0, 255).astype(np.uint8)
    out[0] = img[0]
    out[-1] = img[-1]
    out[:, 0] = img[:, 0]
    out[:, -1] = img[:, -1]
    return out[..., 0] if squeeze else out


# ---- mode filter ----

_MODE_SENTINEL = -1


def _mode_core(xp: torch.Tensor, size: int) -> torch.Tensor:
    """Mode select over padded int16 planes (N, H+2r, W+2r) -> (N, H, W) int16.

    ``xp`` holds the window values inside the image and the -1 sentinel
    outside it; a sentinel matches only sentinels and is never a candidate.
    Each window value is counted by a pairwise equality sum, and one packed
    key ``count*256 + (255 - value)`` (0 for a sentinel; at most 25*256+255,
    so int16) picks the most frequent value, the lowest on a tie; a mode
    seen at most twice leaves the centre pixel.

    The planes are one flat buffer: the window position (dy, dx) of the
    output at base ``b = n*L + y*wp + x`` (L = hp*wp) is element ``b + dy*wp
    + dx``, so each position's values over all bases are one contiguous
    slice. Bases outside the image (x >= W or y >= H) read across rows and
    planes and are dropped at the end. The pairs (p, q) of window positions
    with the same offset d = q - p compare the same two slices shifted, so
    each offset's equality is computed once (12 for size 3, 40 for size 5,
    against 36 and 300 pairs) and added, shifted, to both counts of each of
    its pairs. Counts stay in uint8 (at most 25), and the bool equality is
    read as uint8, so every op is a contiguous elementwise kernel.
    """
    r = size // 2
    hp, wp = xp.shape[-2:]
    hn, wn = hp - 2 * r, wp - 2 * r
    flat = xp.reshape(-1)
    total = flat.numel()
    offset = [py * wp + px for py in range(size) for px in range(size)]
    bases = total - offset[-1]  # every base whose window lies in the buffer
    counts = [torch.ones(bases, dtype=torch.uint8, device=xp.device) for _ in offset]
    for dy in range(size):
        for dx in range(-size + 1, size):
            if dy == 0 and dx <= 0:
                continue
            od = dy * wp + dx  # > 0: wp > 2r >= -dx
            eq = (flat[:total - od] == flat[od:]).view(torch.uint8)
            for py in range(size - dy):
                for px in range(max(0, -dx), min(size, size - dx)):
                    p, q = py * size + px, (py + dy) * size + px + dx
                    view = eq[offset[p]:offset[p] + bases]
                    counts[p] += view
                    counts[q] += view
    best = None
    for o, c in zip(offset, counts):
        v = flat[o:o + bases]
        key = torch.where(v >= 0, (c.to(torch.int16) << 8) + (255 - v), 0)
        best = key if best is None else torch.maximum(best, key, out=best)
    centre = flat[offset[size * size // 2]:offset[size * size // 2] + bases]
    res = flat.new_zeros(total)
    torch.where((best >> 8) > 2, 255 - (best & 255), centre, out=res[:bases])
    return res.view(xp.shape)[..., :hn, :wn]


def mode_plain(planes: torch.Tensor, size: int) -> torch.Tensor:
    """The plain mode filter, (N, H, W) uint8 -> same: :func:`_mode_core`
    over a sentinel-padded int16 copy."""
    r = size // 2
    n, h, w = planes.shape
    xp = torch.full((n, h + 2 * r, w + 2 * r), _MODE_SENTINEL, dtype=torch.int16,
                    device=planes.device)
    xp[:, r:r + h, r:r + w] = planes
    return _mode_core(xp, size).to(torch.uint8)


def _mode_planar_cuda(planes: torch.Tensor, size: int,
                      out: torch.Tensor | None) -> torch.Tensor:
    """The mode filter on the card: kernel K12, one launch over all the
    planes (``ops/cuda_mode.py``); an ``out`` it cannot write straight
    (strided, or sharing bytes with ``planes``) takes a copy."""
    from hipe_tpu_torch.ops import cuda_mode as cm

    planes = planes.contiguous()
    if out is None or (out.is_contiguous() and not cm.overlaps(out, planes)):
        return cm.mode_planar_cuda(planes, size, out=out)
    return _store(cm.mode_planar_cuda(planes, size), out)


def mode_planar(planes: torch.Tensor, channels: int = 3, *, size: int = 3,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H, W) uint8 -> same; PIL ``ImageFilter.ModeFilter(size)``, each
    plane alone (``channels`` is taken for the family's signature). On the
    card kernel K12; on the CPU :func:`mode_plain`."""
    if planes.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {planes.dtype}")
    if size not in (3, 5):
        raise ValueError(f"mode filter size must be 3 or 5, got {size}")
    with span("stats.mode", planes.device):
        if planes.device.type == "cuda":
            return _mode_planar_cuda(planes, size, out)
        return _store(mode_plain(planes, size), out)


def mode_rows(rows: torch.Tensor, channels: int, *, size: int = 3) -> torch.Tensor:
    """Interleaved rows (B, H, W*C) uint8, per-channel mode filter."""
    return _rows_via_planar(mode_planar, rows, channels, size=size)


def mode_nhwc(x: torch.Tensor, *, size: int = 3) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same shape, PIL ModeFilter."""
    return _nhwc_via_rows(mode_rows, x, size=size)


def mode5_planar(planes: torch.Tensor, channels: int = 3, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """PIL ``ImageFilter.ModeFilter(5)`` on planes."""
    return mode_planar(planes, channels, size=5, out=out)


def mode5_rows(rows: torch.Tensor, channels: int) -> torch.Tensor:
    return mode_rows(rows, channels, size=5)


def mode5_nhwc(x: torch.Tensor) -> torch.Tensor:
    return mode_nhwc(x, size=5)


def mode_oracle(img: np.ndarray, size: int = 3) -> np.ndarray:
    """NumPy histogram-scan reference of PIL ModeFilter (test scale): a
    value's count is the box sum of its one-hot plane over the zero-padded
    (truncated) window; the first argmax is the lowest-valued mode, gated
    on a count above 2."""
    if img.ndim == 3:
        return np.stack([mode_oracle(img[..., c], size) for c in range(img.shape[-1])],
                        axis=-1)
    h, w = img.shape
    r = size // 2
    onehot = (img[None] == np.arange(256, dtype=np.int32)[:, None, None]).astype(np.int32)
    op = np.pad(onehot, ((0, 0), (r, r), (r, r)))
    cnt = np.zeros_like(onehot)
    for dy in range(size):
        for dx in range(size):
            cnt += op[:, dy:dy + h, dx:dx + w]
    maxcnt = cnt.max(axis=0)
    maxval = cnt.argmax(axis=0).astype(np.uint8)  # first max = lowest value
    return np.where(maxcnt > 2, maxval, img).astype(np.uint8)
