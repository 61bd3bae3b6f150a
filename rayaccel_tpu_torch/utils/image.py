"""Image output and comparison helpers.

Counterpart of ``rayaccel_tpu/utils/image.py``, the same NumPy code: the
role of DisplayBuffer's float4 -> RGBA8 conversion (reference
DisplayBuffer.cpp:22-74), tone-mapping the HDR accumulation buffer, with
PNG/PFM files in place of the GL presentation path.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(hdr: np.ndarray, spp: int = 1) -> np.ndarray:
    """HDR accumulation -> uint8, dividing by spp then clamping, exactly
    like colorConvert (DisplayBuffer.cpp:22-74): scale = 255/spp, clamp."""
    out = np.clip(hdr * (255.0 / max(spp, 1)), 0.0, 255.0)
    return out.astype(np.uint8)


def encode_png(rgb8: np.ndarray) -> bytes:
    """Minimal dependency-free PNG encoder for (H, W, 3) uint8."""
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))


def write_pfm(path: str, rgb: np.ndarray) -> None:
    """PFM float HDR output, (H, W, 3) float32, bottom-up per spec."""
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        np.flipud(rgb.astype(np.float32)).tofile(f)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
