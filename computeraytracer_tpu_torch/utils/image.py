"""PNG output and input (port of computeraytracer_tpu/utils/image.py).

A headless renderer's display sink is a PNG on disk. Pure stdlib (zlib +
struct) plus NumPy; torch images are copied to the host first.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _numpy(img):
    """torch tensors (any device) and array-likes -> NumPy."""
    if hasattr(img, "detach"):
        return img.detach().cpu().numpy()
    return img


def to_u8(srgb) -> np.ndarray:
    """[0,1] float image -> uint8 with round-half-away (like the canvas
    rgba8unorm store)."""
    arr = np.asarray(_numpy(srgb), np.float32)
    return np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)


def write_png(path: str, srgb) -> None:
    """Write an (H, W, 3) float [0,1] (or uint8) image as RGB8 PNG."""
    arr = np.asarray(_numpy(srgb))
    if arr.dtype != np.uint8:
        arr = to_u8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"expected 3 channels, got {c}")

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-tripping our own files: 8-bit RGB,
    no interlace. Returns (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or color != 2 or interlace != 0:
                raise ValueError("only 8-bit RGB non-interlaced supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = 1 + 3 * w
    out = np.empty((h, 3 * w), np.uint8)
    prev = np.zeros(3 * w, np.uint8)
    for y in range(h):
        line = raw[y * stride:(y + 1) * stride]
        filt, scan = line[0], np.frombuffer(line[1:], np.uint8).copy()
        if filt == 0:
            row = scan
        elif filt == 2:  # Up
            row = (scan + prev).astype(np.uint8)
        else:
            # 1 (Sub) / 3 (Average) / 4 (Paeth) need sequential unfiltering
            row = scan
            for i in range(3 * w):
                a = int(row[i - 3]) if i >= 3 else 0
                b = int(prev[i])
                c = int(prev[i - 3]) if i >= 3 else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                row[i] = (int(scan[i]) + pred) & 0xFF
        out[y] = row
        prev = row
    return out.reshape(h, w, 3)
