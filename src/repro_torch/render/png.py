"""Dependency-free PNG I/O (stdlib zlib only — accelerator hosts often have
no display stack, the same constraint that shaped ``coloring.write_svg``).

``write_png`` emits 8-bit RGB, one IDAT, filter type 0 on every scanline —
the simplest spec-conformant stream, readable by any viewer. ``read_png``
is the matching subset decoder (8-bit RGB/RGBA, filters 0–2, single image)
used by the round-trip tests and the chip smoke's content check; it is
not a general PNG reader.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> str:
    """Write an [H, W, 3] uint8 RGB image; returns ``path``."""
    img = np.asarray(image)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(
            f"write_png expects [H, W, 3] uint8, got {img.shape} {img.dtype}"
        )
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    # Filter byte 0 (None) before every scanline.
    raw = np.empty((h, 1 + w * 3), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * 3)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))
    return str(path)


def read_png(path: str) -> np.ndarray:
    """Read a PNG written by ``write_png`` (or any 8-bit RGB/RGBA stream
    using only filters 0–2); returns [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    w = h = None
    channels = 3
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or color not in (2, 6):
                raise ValueError(
                    f"{path}: unsupported PNG (depth={depth}, color={color})"
                )
            channels = 3 if color == 2 else 4
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    stride = 1 + w * channels
    raw = raw.reshape(h, stride)
    out = np.zeros((h, w * channels), np.uint8)
    for y in range(h):
        filt, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if filt == 0:
            out[y] = line
        elif filt == 1:  # Sub: add left pixel
            row = line.reshape(w, channels)
            np.cumsum(row, axis=0, out=row)  # mod-256 via uint8 cast below
            out[y] = (row % 256).reshape(-1)
        elif filt == 2:  # Up: add pixel above
            out[y] = (line + out[y - 1]) % 256
        else:
            raise ValueError(f"{path}: unsupported PNG filter {filt}")
    return out.reshape(h, w, channels)[:, :, :3].copy()
