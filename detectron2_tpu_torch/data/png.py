"""PNG reading and writing in numpy and zlib, for machines without PIL.

The port reads images with PIL where PIL imports (as the JAX package does,
``detectron2_tpu/data/detection_utils.py:82``); where it does not, PNG files
go through :func:`read_png`. It decodes what COCO-style datasets hold:
8-bit grayscale, gray + alpha, RGB and RGBA, non-interlaced, any of the five
row filters, giving the pixels PIL gives. :func:`write_png` writes the same
formats (the synthetic datasets of the tests and of ``chip_smoke.py``).

Rows filtered with None, Sub or Up decode as whole-row numpy operations;
Average and Paeth rows depend on the pixel to their left and decode byte by
byte in Python, which is slow for large images (PIL's encoder picks them
often; :func:`write_png` uses only None, Sub and Up).
"""

import struct
import zlib
from typing import Optional

import numpy as np

__all__ = ["PNG_SIGNATURE", "is_png", "read_png", "write_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (8-bit samples only)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
# None, Sub and Up: the row filters that decode as whole-row operations
_FAST_FILTERS = (0, 1, 2)


def is_png(head: bytes) -> bool:
    return head[:8] == PNG_SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG: truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in chunk {ctype!r}")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _unfilter_slow(ftype: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4), in place, byte by byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    ftypes, data = rows[:, 0], rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        f, line = int(ftypes[y]), data[y]
        if f == 0:
            cur = line
        elif f == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = line + prior
        elif f in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_slow(f, buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {f}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path_or_bytes) -> np.ndarray:
    """Decode a PNG: ``[H, W]`` uint8 for grayscale, ``[H, W, C]`` for gray +
    alpha (C = 2), RGB (3) and RGBA (4), as ``np.asarray(PIL.Image.open(f))``.
    Refuses other bit depths, palettes and interlacing."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if not is_png(data):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf":
            # PIL would turn the image by its EXIF orientation
            raise ValueError("PNG: an eXIf chunk; read this file with PIL")
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"PNG: bit depth {depth}, color type {color}, interlace {interlace}; "
            "only 8-bit gray, gray + alpha, RGB and RGBA, non-interlaced, are read without PIL"
        )
    channels = _CHANNELS[color]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG: image data of the wrong size")
    pixels = _unfilter(raw, height, stride, channels)
    return pixels.reshape(height, width) if channels == 1 else pixels.reshape(height, width, channels)


def _filtered(img: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Rows of ``img`` ([H, stride] uint8) under one filter type."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _encode(rows: np.ndarray, ftypes: np.ndarray, width: int, channels: int) -> bytes:
    """PNG bytes of filtered rows (``[H, stride]`` uint8) and their filter types."""
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    raw = np.concatenate([ftypes.astype(np.uint8)[:, None], rows], axis=1).tobytes()

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)

    return (
        PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", width, rows.shape[0], 8, color, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: Optional[str], image: np.ndarray) -> bytes:
    """Encode ``[H, W]`` or ``[H, W, C]`` (C in 1..4) uint8 as PNG; returns
    the bytes and writes them to ``path`` unless it is None. Each row takes
    the filter, of None, Sub and Up, whose bytes have the least sum as signed
    values (libpng's heuristic over the filters that decode fast here)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png: uint8 images only, got {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    height, width, channels = image.shape
    rows = image.reshape(height, width * channels)
    candidates = np.stack([_filtered(rows, channels, f) for f in _FAST_FILTERS])
    best = np.abs(candidates.astype(np.int8).astype(np.int64)).sum(axis=2).argmin(axis=0)
    data = _encode(candidates[best, np.arange(height)], np.asarray(_FAST_FILTERS)[best], width, channels)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data
