"""Write :mod:`hud_font`, the HUD's bitmap font, from Pillow's bitmap
default font (``ImageFont.load_default_imagefont()``, courB08).

The HUD draws on the host, and the card's machine has no Pillow, so the
port keeps the glyphs as source.  This script reads the font's PILfont
metrics (per glyph: advance, box relative to the pen and the baseline,
box in the glyph sheet) and its 1-bit glyph sheet, and writes one entry
per printable ASCII character (32..126) with its bitmap rows.  It needs
Pillow, so it runs where Pillow is installed:

    python -m banggameengine_tpu_torch.app.make_hud_font
"""

from __future__ import annotations

import io
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hud_font.py")
FIRST, LAST = 32, 126


def _font_data() -> tuple[bytes, np.ndarray]:
    """The PILfont metrics file and the glyph sheet bool[h, w] of Pillow's
    bitmap default font, as ``load_default_imagefont`` reads them."""
    from PIL import ImageFont

    grabbed = {}
    load = ImageFont.ImageFont._load_pilfont_data

    def grab(self, file, image):
        grabbed["data"] = file.read()
        grabbed["sheet"] = np.asarray(image.convert("L")) > 0
        return load(self, io.BytesIO(grabbed["data"]), image)

    ImageFont.ImageFont._load_pilfont_data = grab
    try:
        ImageFont.load_default_imagefont()
    finally:
        ImageFont.ImageFont._load_pilfont_data = load
    return grabbed["data"], grabbed["sheet"]


def glyph_table() -> tuple[int, int, dict]:
    """(baseline, line height, {code: (dx, dy, x0, y0, x1, y1, rows)}):
    the baseline and height over all 256 glyphs, as Pillow's font object
    sets them; ``rows`` one int per bitmap row, bit k for column k."""
    data, sheet = _font_data()
    start = data.index(b"DATA\n") + 5
    metrics = np.frombuffer(data[start:start + 256 * 20],
                            ">i2").reshape(256, 10).astype(int)
    y_lo = min(0, int(metrics[:, 3].min()))
    y_hi = max(0, int(metrics[:, 5].max()))
    glyphs = {}
    for code in range(FIRST, LAST + 1):
        dx, dy, x0, y0, x1, y1, sx0, sy0, sx1, sy1 = metrics[code].tolist()
        bits = sheet[sy0:sy1, sx0:sx1]
        rows = tuple(int(sum(1 << k for k in np.nonzero(r)[0])) for r in bits)
        glyphs[code] = (dx, dy, x0, y0, x1, y1, rows)
    return -y_lo, y_hi - y_lo, glyphs


def main() -> None:
    baseline, height, glyphs = glyph_table()
    lines = [
        '"""The HUD\'s bitmap font: Pillow\'s bitmap default font (courB08,',
        "``ImageFont.load_default_imagefont()``) for printable ASCII, written",
        "by ``make_hud_font.py``; do not edit.",
        "",
        "``GLYPHS[code] = (dx, dy, x0, y0, x1, y1, rows)``: the pen's advance,",
        "the glyph's box relative to the pen and the baseline, and its bitmap,",
        'one int per row, bit k for column k."""',
        "",
        f"BASELINE = {baseline}",
        f"HEIGHT = {height}",
        "GLYPHS = {",
    ]
    for code, (dx, dy, x0, y0, x1, y1, rows) in glyphs.items():
        lines.append(f"    {code}: ({dx}, {dy}, {x0}, {y0}, {x1}, {y1}, "
                     f"{rows!r}),  # {chr(code)!r}")
    lines.append("}")
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {OUT}: {len(glyphs)} glyphs, baseline {baseline}, "
          f"height {height}")


if __name__ == "__main__":
    main()
