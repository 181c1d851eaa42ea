"""PNG reading and writing on ``zlib``, ``struct`` and numpy.

The JAX package reads and writes its frames through cv2; the port's
machine has neither cv2 nor PIL, so the port carries its own codec.

- :func:`read_png` decodes every PNG that ``cv2.imread(path,
  cv2.IMREAD_COLOR)`` decodes into 8 bits, and gives the same pixels in RGB
  order: colour types 0, 2, 3, 4 and 6, bit depths 1 to 16, the five row
  filters and Adam7 interlacing. As cv2 does, grey is replicated to three
  channels, alpha is dropped (and ``tRNS`` ignored), palettes are expanded,
  grey of 1, 2 or 4 bits is scaled to 0..255 by bit replication, and a
  16-bit sample keeps its high byte.
- :func:`write_png` writes 8-bit RGB, not interlaced, every row with
  filter 0.

A chunk whose CRC does not match raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel by colour type: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends without IEND")


def _paeth_row(raw: bytes, prior: bytes, bpp: int) -> bytearray:
    """Filter 4, byte by byte: the predictor is the left byte a, the one
    above b or the upper-left c, whichever is nearest a + b - c, ties in
    that order."""
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _avg_row(raw: bytes, prior: bytes, bpp: int) -> bytearray:
    """Filter 3: the predictor is floor((left + above) / 2)."""
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(buf: memoryview, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 rows of one image (or one Adam7 pass) from its
    filtered bytes, each row led by its filter type."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        row = buf[y * (stride + 1):(y + 1) * (stride + 1)]
        kind, raw = row[0], np.frombuffer(row[1:], np.uint8)
        if kind == 0:
            cur = raw
        elif kind == 1:
            # a row holds whole pixels of bpp bytes (bpp is 1 below 8 bits)
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = raw + prior
        elif kind == 3:
            cur = np.frombuffer(_avg_row(raw.tobytes(), prior.tobytes(), bpp),
                                np.uint8)
        elif kind == 4:
            cur = np.frombuffer(
                _paeth_row(raw.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes → (h, w, channels) integer samples at
    their bit depth."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = rows
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        s = ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, rows.shape[1] * per)
    return s[:, :w * channels].reshape(h, w, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB, as ``cv2.imread(IMREAD_COLOR)``
    then ``COLOR_BGR2RGB`` gives it."""
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"bad PNG colour type {ctype} / bit depth {depth}")
    if comp != 0 or filt != 0 or interlace not in (0, 1) or w == 0 or h == 0:
        raise ValueError("unsupported PNG header")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    buf = memoryview(zlib.decompress(b"".join(idat)))
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        n = ph * (stride + 1)
        if pos + n > len(buf):
            raise ValueError("PNG image data is shorter than its header says")
        rows = _unfilter(buf[pos:pos + n], ph, stride, bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n
    if ctype == 3:
        if int(img.max()) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[img[..., 0]]
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    elif depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the PNG at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB → PNG bytes: 8-bit RGB, not interlaced, filter
    0 on every row."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB to ``path`` as PNG."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
