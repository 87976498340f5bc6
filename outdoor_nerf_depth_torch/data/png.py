"""PNG reading and writing with the standard library (`zlib`, `struct`) and numpy.

The port reads and writes the KITTI-layout scenes without an imaging
library: 8-bit grey, RGB and RGBA images and 16-bit grey depth maps, the
formats the driving-scene layout uses. `read_png` returns what
`np.asarray(PIL.Image.open(path))` returns for these formats: uint8
[H, W], [H, W, 3] or [H, W, 4], or uint16 [H, W] holding the raw 16-bit
values. It takes non-interlaced images with any of the five row filters
(encoders such as PIL's choose a filter per row); any other colour type,
bit depth or an interlaced image raises ValueError. `write_png` writes
every row with filter 0 (None).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the types read and written here
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a non-interlaced image: [H, stride] bytes."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: add the byte one pixel to the left
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up: add the byte above
            cur = line + prev
        elif kind == 3:  # Average of left and above, floored
            cur = line.astype(np.int32)
            up = prev.astype(np.int32)
            cur[:bpp] = (cur[:bpp] + up[:bpp] // 2) & 0xFF
            for i in range(bpp, stride, bpp):
                cur[i:i + bpp] = (cur[i:i + bpp] + (cur[i - bpp:i] + up[i:i + bpp]) // 2) & 0xFF
            cur = cur.astype(np.uint8)
        elif kind == 4:  # Paeth predictor of left, above and upper left
            cur = line.astype(np.int32)
            up = prev.astype(np.int32)
            cur[:bpp] = (cur[:bpp] + up[:bpp]) & 0xFF  # left and upper left are 0
            for i in range(bpp, stride, bpp):
                a, b, c = cur[i - bpp:i], up[i:i + bpp], up[i - bpp:i]
                p = a + b - c
                pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[i:i + bpp] = (cur[i:i + bpp] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes (see the module docstring)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} is not supported (grey, RGB, RGBA only)")
    if depth != 8 and not (depth == 16 and colour == 0):
        raise ValueError(f"PNG bit depth {depth} with colour type {colour} is not supported")
    if interlace != 0 or compression != 0 or filter_method != 0:
        raise ValueError("interlaced or non-standard PNGs are not supported")
    channels, nbytes = _CHANNELS[colour], depth // 8
    bpp = channels * nbytes
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {height * (stride + 1)}")
    pixels = _unfilter(raw, height, stride, bpp)
    if nbytes == 2:
        return pixels.view(">u2").astype(np.uint16).reshape(height, width)
    return pixels.reshape((height, width) if channels == 1 else (height, width, channels))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of uint8 [H, W], [H, W, 3] or [H, W, 4], or uint16 [H, W]."""
    image = np.asarray(image)
    channels = 1 if image.ndim == 2 else image.shape[-1] if image.ndim == 3 else 0
    if channels not in _COLOUR_TYPE or image.dtype not in (np.uint8, np.uint16) or (
            image.dtype == np.uint16 and channels != 1):
        raise ValueError(f"cannot write a {image.dtype} image of shape {image.shape} as PNG")
    height, width = image.shape[:2]
    depth = 8 * image.dtype.itemsize
    rows = np.ascontiguousarray(image, dtype=">u2" if depth == 16 else np.uint8)
    rows = rows.reshape(height, -1).view(np.uint8)
    filtered = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, _COLOUR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(image))
