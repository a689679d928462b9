"""PNG output with numpy and the standard library (no imaging package)."""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def write_png(path: str | Path, img: np.ndarray) -> Path:
    """Write an [H, W, 3] image with values in [0, 1] as an 8-bit RGB PNG."""
    rgb = (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0 + 0.5)
    rgb = rgb.astype(np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {rgb.shape}")
    h, w, _ = rgb.shape
    # Filter type 0 (none) in front of every scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + chunk(b"IEND", b""))
    path = Path(path)
    path.write_bytes(png)
    return path
