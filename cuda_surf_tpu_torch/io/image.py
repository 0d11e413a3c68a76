"""Dependency-free grayscale image IO: PGM, binary PPM and 8-bit PNG (copy
of cuda_surf_tpu/io/image.py).

Copied rather than imported, because importing the JAX package imports
jax.  NumPy only.  PNG covers the non-interlaced 8-bit gray / RGB / RGBA
subset; RGB becomes gray with the BT.601 weights of OpenCV's
IMREAD_GRAYSCALE.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def imread_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(b"P5") or head.startswith(b"P2"):
        return read_pgm(path)
    if head == _PNG_SIG:
        return read_png_gray(path)
    raise ValueError(f"unsupported image format: {path}")


def read_pgm(path: str) -> np.ndarray:
    """Read an 8/16-bit PGM (P5 binary or P2 ascii) as uint8 (H, W)."""
    with open(path, "rb") as f:
        data = f.read()

    # Tokenize header (magic, width, height, maxval) skipping '#' comments.
    tokens = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        img = np.frombuffer(data, dtype=dtype, count=w * h, offset=pos).reshape(h, w)
    elif magic == b"P2":
        flat = np.array(data[pos:].split(), dtype=np.int64)[: w * h]
        img = flat.reshape(h, w)
    else:
        raise ValueError(f"not a PGM file: {path}")
    if maxval > 255:
        img = (img.astype(np.float64) * 255.0 / maxval)
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img.astype(np.uint8))
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as binary PPM (P6)."""
    img = np.ascontiguousarray(img.astype(np.uint8))
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 grayscale (H, W) or RGB (H, W, 3) PNG."""
    img = np.ascontiguousarray(img.astype(np.uint8))
    if img.ndim == 2:
        h, w = img.shape
        color, stride = 0, w
    else:
        h, w, c = img.shape
        if c != 3:
            raise ValueError("write_png expects gray or RGB")
        color, stride = 2, 3 * w
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"not a PNG file: {path}")
    pos = 8
    idat = b""
    w = h = bitdepth = color = interlace = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bitdepth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat += body
        elif ctype == b"IEND":
            break
    if bitdepth != 8 or interlace != 0:
        raise ValueError("only 8-bit non-interlaced PNG supported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    raw = zlib.decompress(idat)
    stride = w * channels
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    offset = 0
    for row in range(h):
        ftype = raw[offset]
        line = np.frombuffer(raw, np.uint8, stride, offset + 1).copy()
        offset += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev) % 256
        else:  # Sub / Average / Paeth need the sequential left neighbour
            line = line.astype(np.int32)
            out = np.zeros(stride, np.int32)
            for i in range(stride):
                a = out[i - channels] if i >= channels else 0
                b = int(prev[i])
                if ftype == 1:
                    out[i] = (line[i] + a) % 256
                elif ftype == 3:
                    out[i] = (line[i] + (a + b) // 2) % 256
                elif ftype == 4:
                    c = int(img[row - 1, i - channels]) if (row > 0 and i >= channels) else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    out[i] = (line[i] + pred) % 256
                else:
                    raise ValueError(f"bad PNG filter {ftype}")
            line = out
        img[row] = line.astype(np.uint8)
        prev = img[row]
    img = img.reshape(h, w, channels)
    if channels == 1:
        return img[:, :, 0]
    if channels == 2:
        return img[:, :, 0]
    rgb = img[:, :, :3].astype(np.float64)
    gray = 0.299 * rgb[:, :, 0] + 0.587 * rgb[:, :, 1] + 0.114 * rgb[:, :, 2]
    return np.clip(np.rint(gray), 0, 255).astype(np.uint8)
