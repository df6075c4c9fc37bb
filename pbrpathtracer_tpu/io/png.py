"""PNG export — parity with ExportAt (main.cpp:760-811): writes the
3-channel byte buffer (the reference flips its GL-bottom-up buffer
vertically; our images are already top-down so the user-visible result is
identical), auto-naming ``scene_YYYYMMDD_H_M_S.png``.

Encoding and decoding use only ``zlib`` and ``struct``: 8-bit RGB, no
interlace, no scanline filter. The reader takes back what the writer
writes and nothing else.
"""

from __future__ import annotations

import datetime
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def tonemap_to_u8(mean_radiance: np.ndarray) -> np.ndarray:
    """clamp to [0,1], ×255, truncate — pathtracer.cpp:802-812 (no gamma)."""
    res = np.clip(np.asarray(mean_radiance), 0.0, 1.0)
    return (res * 255.0).astype(np.uint8)


def auto_filename(directory: str = ".", now=None) -> str:
    """scene_YYYYMMDD_H_M_S.png (main.cpp:783-809 — note: hour/min/sec are
    NOT zero-padded in the reference; parity preserved)."""
    t = now if now is not None else datetime.datetime.now()
    name = f"scene_{t.year}{t.month:02d}{t.day:02d}_{t.hour}_{t.minute}_{t.second}.png"
    return os.path.join(directory, name)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb_u8) -> None:
    """Write a u8[H, W, 3] image as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb_u8, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected u8[H, W, 3], got {rgb.shape}")
    h, w, _ = rgb.shape
    # filter type 0 (None) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG as ``write_png`` writes it (8-bit RGB, no interlace,
    filter 0 on every scanline) → u8[H, W, 3]. Any other PNG raises
    ValueError; decode those with Pillow."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: not an 8-bit RGB non-interlaced PNG "
                         f"(depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: scanline filters other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def export_png(path_or_dir: str, image, samples: int | None = None):
    """Export a render to PNG.

    ``image``: f32[H,W,3] mean radiance (or accumulation buffer with
    ``samples`` given). If ``path_or_dir`` is a directory, an auto filename
    is generated. Returns the written path.
    """
    img = np.asarray(image)
    if samples is not None:
        img = img / float(samples)
    path = (auto_filename(path_or_dir) if os.path.isdir(path_or_dir)
            else path_or_dir)
    write_png(path, tonemap_to_u8(img))
    return path
