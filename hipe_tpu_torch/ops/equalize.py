"""Global-statistics point operations (``hipe_tpu.ops.equalize``): so far its
colorize tables only.

``colorize_lut`` builds PIL ``ImageOps.colorize``'s three wedge tables with
Pillow's own integer arithmetic (floor-division interpolation over the point
ranges), so the tables are exact. The serving pipeline applies them as the
mirror of its grayscale output (``ServingPipeline(colorize=...)``): a gather
of the L rows through the three tables. Colours are RGB triples, ``#rgb`` or
``#rrggbb``; other colour strings (names such as ``"navy"``) are parsed by
PIL's ``ImageColor``, which is needed for those alone. Equalize,
autocontrast, contrast, color, sharpness and the mode filter are still to be
ported (ROADMAP.md).
"""

from __future__ import annotations

import re

import numpy as np

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
