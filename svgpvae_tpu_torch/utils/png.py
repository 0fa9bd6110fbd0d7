"""8-bit RGB PNG files with the standard library alone (zlib, struct).

  * `write_png(path, rgb, text)` -- signature, IHDR, one IDAT (filter 0
    on every row), one tEXt chunk per entry of `text` (Latin-1), IEND;
  * `read_png(path)` -- (rgb, text) back from a file this writer made
    (8-bit RGB, not interlaced, every row filter 0).

The pictures' titles and panel labels travel in the tEXt chunks, since
the port draws no fonts (utils.plots).  Read them with `read_png` or
any PNG tool (`python -c "from svgpvae_tpu_torch.utils.png import
read_png; print(read_png('x.png')[1])"`).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray,
              text: Optional[Dict[str, str]] = None) -> None:
    """Write the (H, W, 3) uint8 array `rgb` to `path`, with one tEXt
    chunk per (keyword, text) entry of `text`."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, not "
                         f"{rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, 3 * w)], axis=1)
    parts = [SIGNATURE,
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
             _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))]
    for key, value in (text or {}).items():
        if not 1 <= len(key) <= 79:
            raise ValueError(f"PNG text keyword {key!r}: 1 to 79 characters")
        parts.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                            + str(value).encode("latin-1")))
    parts.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def read_png(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """(the (H, W, 3) uint8 pixels, the tEXt entries) of a file that
    `write_png` wrote; raises ValueError on any other layout or a bad
    CRC."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, text = len(SIGNATURE), None, [], {}
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, payload = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + payload) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"tEXt":
            key, value = payload.split(b"\0", 1)
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"IEND":
            break
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG of write_png's "
                         f"layout (IHDR {header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy(), text
