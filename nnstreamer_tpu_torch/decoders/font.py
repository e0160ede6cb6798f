"""Bitmap-font text overlay for decoder video output.

Counterpart of the JAX package's ``decoders/font.py`` (parity target: the
reference's tensordec-font.c 8×13 raster font and the ``draw_label``
users in tensordec-boundingbox.cc and tensordec-pose.c, which stamp label
text into the RGBA overlay frame).

Glyphs are rasterized once per process with PIL's built-in bitmap font
into a boolean mask cache; where PIL is not installed every printable
character is a filled block of the same width, so the layout survives.
:func:`glyph_source` says which of the two a process uses.  Drawing is a
numpy masked assignment on the host overlay frame.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import numpy as np

_lock = threading.Lock()
_glyphs: Dict[str, np.ndarray] = {}
GLYPH_H = 13  # match the reference's 13-row raster height


def _rasterize(ch: str) -> np.ndarray:
    """Boolean (GLYPH_H, w) mask for one character."""
    try:
        from PIL import Image, ImageDraw, ImageFont

        font = ImageFont.load_default()
        l, t, r, b = font.getbbox(ch)
        w = max(r, 1)
        img = Image.new("L", (w, GLYPH_H), 0)
        ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=font)
        return np.asarray(img) > 127
    except Exception:
        # PIL-less fallback: fixed-width filled block so layout survives
        m = np.zeros((GLYPH_H, 8), bool)
        if not ch.isspace():
            m[2:11, 1:7] = True
        return m


def glyph_source() -> str:
    """``"PIL"`` when glyphs come from PIL's bitmap font, ``"blocks"``
    when PIL is missing and every glyph is a filled block."""
    try:
        from PIL import ImageFont

        ImageFont.load_default()
        return "PIL"
    except Exception:
        return "blocks"


def glyph(ch: str) -> np.ndarray:
    with _lock:
        g = _glyphs.get(ch)
        if g is None:
            g = _glyphs[ch] = _rasterize(ch)
        return g


def text_mask(text: str) -> np.ndarray:
    """Boolean (GLYPH_H, total_w) mask for a string."""
    if not text:
        return np.zeros((GLYPH_H, 0), bool)
    parts = [glyph(c) for c in text]
    return np.concatenate(parts, axis=1)


def draw_text(frame: np.ndarray, x: int, y: int, text: str,
              color: Sequence[int] = (0, 255, 0, 255)) -> None:
    """Stamp ``text`` into an (H, W, C) uint8 frame at (x, y), clipped.

    Mirrors the reference draw_label semantics: the label is drawn above
    the given anchor when it fits, pixels outside the frame are dropped.
    """
    h, w = frame.shape[:2]
    mask = text_mask(text)
    mh, mw = mask.shape
    if mh == 0 or mw == 0:
        return
    x0, y0 = max(int(x), 0), max(int(y), 0)
    x1, y1 = min(int(x) + mw, w), min(int(y) + mh, h)
    if x0 >= x1 or y0 >= y1:
        return
    sub = mask[y0 - int(y):y1 - int(y), x0 - int(x):x1 - int(x)]
    c = np.asarray(color[:frame.shape[2]], np.uint8)
    frame[y0:y1, x0:x1][sub] = c


def label_anchor(box_x: int, box_y: int) -> Tuple[int, int]:
    """Place a label just above a box corner (reference behavior), or at
    the corner when the box touches the top edge."""
    y = box_y - GLYPH_H - 1
    return box_x, (y if y >= 0 else box_y + 1)
