"""Textures: the PNG codec, the checker fallback and the 1x1 white texture.

Counterpart of ``banggameengine_tpu/scene/textures.py``.  The JAX package
decodes images with PIL, which the card's machine lacks, so
:func:`load_texture_rgba8` decodes PNG itself with ``zlib`` and numpy:
non-interlaced 8-bit PNGs of colour types 0 (grey), 2 (RGB), 3 (palette),
4 (grey + alpha) and 6 (RGBA), all five row filters, ``tRNS``
transparency as PIL's ``convert("RGBA")`` applies it.  Any other file
raises ``ValueError``, and the resource manager falls back to the checker
with a warning, as it does for an undecodable texture.
:func:`encode_png_rgba8` writes a frame as an RGBA PNG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> bytes a pixel


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    at = 8
    while at + 12 <= len(data):
        (length,) = struct.unpack(">I", data[at:at + 4])
        kind = data[at + 4:at + 8]
        payload = data[at + 8:at + 8 + length]
        if len(payload) != length:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[at + 8 + length:at + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        at += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file has no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: uint8[height, stride]."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data too short")
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        base = y * (stride + 1)
        kind = raw[base]
        line = np.frombuffer(raw, np.uint8, stride, base + 1)
        if kind == 0:
            row = line.copy()
        elif kind == 1:      # Sub: a running sum along each channel
            row = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            row = line + prior
        elif kind in (3, 4):  # Average, Paeth: serial along the row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
                else:
                    ul = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(left, up[x], ul)) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = row
        prior = out[y]
    return out


def decode_png_rgba8(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8[H, W, 4] RGBA."""
    header, palette, trns, idat = None, None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                   bpp).reshape(height, width, bpp)
    out = np.empty((height, width, 4), np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:len(palette)]
            alpha[:len(t)] = t
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        out[..., :3] = palette[idx]
        out[..., 3] = alpha[idx]
        return out
    colour = px[..., :1].repeat(3, axis=-1) if ctype in (0, 4) else px[..., :3]
    out[..., :3] = colour
    if ctype in (4, 6):
        out[..., 3] = px[..., -1]
    else:
        out[..., 3] = 255
        if trns is not None:   # one transparent colour, 16-bit samples
            key = np.frombuffer(trns, ">u2")[:3 if ctype == 2 else 1]
            if ctype == 0:
                key = key.repeat(3)
            out[..., 3] = np.where(
                (colour.astype(np.uint16) == key).all(-1), 0, 255)
    return out


def load_texture_rgba8(path: str) -> np.ndarray:
    """Decode an image file to uint8[H, W, 4] (RGBA), like stb's forced
    4-channel load.  Raises ``ValueError`` for anything but the PNGs the
    module docstring lists."""
    with open(path, "rb") as f:
        return decode_png_rgba8(f.read())


def encode_png_rgba8(image: np.ndarray) -> bytes:
    """uint8[H, W, 4] -> PNG bytes (colour type 6, no row filter)."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    if c != 4:
        raise ValueError(f"expected an RGBA image, got {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 4)], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def make_checker_rgba8(size: int = 2) -> np.ndarray:
    """Magenta/black checker fallback texture, so a missing texture is
    obvious."""
    y, x = np.mgrid[0:size, 0:size]
    on = ((x + y) % 2 == 0)
    tex = np.zeros((size, size, 4), np.uint8)
    tex[..., 0] = np.where(on, 255, 30)
    tex[..., 1] = np.where(on, 0, 30)
    tex[..., 2] = np.where(on, 255, 30)
    tex[..., 3] = 255
    return tex


def make_white_rgba8() -> np.ndarray:
    """1x1 white texture for untextured draws."""
    return np.full((1, 1, 4), 255, np.uint8)


def approx_bytes(tex: np.ndarray) -> int:
    """W * H * 4, the JAX package's cache accounting."""
    return int(tex.shape[0]) * int(tex.shape[1]) * 4
