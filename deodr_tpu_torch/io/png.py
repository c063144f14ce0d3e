"""A minimal PNG reader (standard library ``zlib`` + numpy).

Reads what the repository's texture files are: 8 bits per sample,
greyscale, RGB or RGBA, not interlaced. Anything else raises
``ValueError``. It stands in for an imaging library, which the machines
this package runs on may not have.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type → samples per pixel


def read_png(path) -> np.ndarray:
    """The image as uint8 (height, width, channels); (height, width) for
    greyscale."""
    with open(path, "rb") as fid:
        data = fid.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit greyscale/RGB/RGBA PNGs without interlacing are read "
            f"(bit depth {depth}, colour type {colour}, interlace {interlace})"
        )
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected {height * (stride + 1)}")
    lines = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = out[y] = _unfilter(int(lines[y, 0]), lines[y, 1:], prev, bpp)
    image = out.reshape(height, width, bpp)
    return image[:, :, 0] if bpp == 1 else image


def _unfilter(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG specification, section 9): every
    byte adds, modulo 256, a prediction from the byte ``bpp`` to its left
    (a), the byte above (b) and the byte above-left (c)."""
    if kind == 0:
        return line
    if kind == 2:  # Up
        return line + prev  # uint8 arithmetic wraps modulo 256
    if kind == 1:  # Sub: a running sum per sample
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter type {kind}")
    # Average and Paeth depend on the byte just decoded: a scalar loop
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return np.frombuffer(bytes(cur), np.uint8)
