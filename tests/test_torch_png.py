"""The port's PNG codec (``flair_tpu_torch.utils.png``) against cv2.

- PNGs written by cv2 (grey 8 / 16-bit, RGB 8 / 16-bit with each row
  filter forced in turn, RGBA, bilevel, many IDAT chunks), by PIL (grey +
  alpha, 1-bit, 16-bit grey, palettes of 1 / 2 / 4 / 8 bits with tRNS) and
  by a small encoder here (grey of 1 / 2 / 4 bits, every colour type and
  depth with Adam7, each of the five filters on every row, odd widths so
  sub-byte rows are padded) decode to the pixels ``flair_tpu.cli.
  load_frames`` gives, exactly;
- the port's ``load_frames`` equals the JAX package's on a clip of
  mixed-format frames (natural sort included);
- PNGs the port writes decode in cv2 to the source, bit for bit;
- a chunk with a bad CRC raises.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from flair_tpu.cli import load_frames as j_load_frames
from flair_tpu_torch.utils import png

torch.set_num_threads(1)
H, W = 13, 21          # odd sizes: every Adam7 pass partial, rows padded


def rand(seed, shape, hi=256, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)


def cv2_rgb(path):
    """The reference: what flair_tpu.cli.load_frames reads, in uint8."""
    d = path.parent
    frames = j_load_frames(str(d))
    assert frames.shape[0] == 1
    return np.round(frames[0] * 255.0).astype(np.uint8)


def check(path):
    ref = cv2_rgb(path)
    got = png.read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------ a small encoder ---


def _forward_filter(kind, raw, prior, bpp):
    out = bytearray(len(raw))
    for i in range(len(raw)):
        a = raw[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (raw[i] - pred) % 256
    return bytes(out)


def _pack(samples, depth):
    """(h, w, c) integer samples → per-row big-endian packed bytes."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in flat]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in flat]
    per = 8 // depth
    rows = []
    for r in flat:
        r = np.concatenate([r, np.zeros((-len(r)) % per, np.uint32)])
        r = r.reshape(-1, per)
        shifts = np.arange(8 - depth, -1, -depth)
        rows.append((r << shifts).sum(1).astype(np.uint8).tobytes())
    return rows


def encode(samples, depth, ctype, *, palette=None, interlace=False,
           filters=(0, 1, 2, 3, 4), idat_size=37):
    """A PNG of ``samples`` (h, w, c), row filters cycling through
    ``filters``, IDAT split every ``idat_size`` bytes."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    body, k = b"", 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        prior = bytes(len(rows[0]))
        for raw in rows:
            kind = filters[k % len(filters)]
            k += 1
            body += bytes([kind]) + _forward_filter(kind, raw, prior, bpp)
            prior = raw
    z = zlib.compress(body)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
        out += chunk(b"tRNS", bytes([0, 128]))
    for i in range(0, len(z), idat_size):
        out += chunk(b"IDAT", z[i:i + idat_size])
    return out + chunk(b"IEND", b"")


# ------------------------------------------------------------------ cases ---


@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb16", "rgba",
                                  "bilevel", "many_idat"]
                         + [f"rgb8_filter{f}" for f in range(5)])
def test_cv2_written(tmp_path, kind):
    p = tmp_path / "f" / "0001.png"
    p.parent.mkdir()
    params = []
    if kind == "grey8":
        img = rand(0, (H, W))
    elif kind == "grey16":
        img = rand(1, (H, W), 65536, np.uint16)
    elif kind == "rgb16":
        img = rand(2, (H, W, 3), 65536, np.uint16)
    elif kind == "rgba":
        img = rand(3, (H, W, 4))
    elif kind == "bilevel":
        img = rand(4, (H, W), 2) * 255
        params = [cv2.IMWRITE_PNG_BILEVEL, 1]
    elif kind == "many_idat":
        img = rand(5, (64, 64, 3))
        params = [cv2.IMWRITE_PNG_ZLIBBUFFER_SIZE, 128,
                  cv2.IMWRITE_PNG_COMPRESSION, 0]
    else:
        f = int(kind[-1])
        flag = (cv2.IMWRITE_PNG_FILTER_NONE, cv2.IMWRITE_PNG_FILTER_SUB,
                cv2.IMWRITE_PNG_FILTER_UP, cv2.IMWRITE_PNG_FILTER_AVG,
                cv2.IMWRITE_PNG_FILTER_PAETH)[f]
        # a smooth ramp with noise: the filters' predictors all matter
        yy, xx = np.mgrid[:H, :W]
        img = ((yy * 9 + xx * 5)[..., None] + rand(6 + f, (H, W, 3), 7)
               ).astype(np.uint8)
        params = [cv2.IMWRITE_PNG_FILTER, flag]
    assert cv2.imwrite(str(p), img, params)
    if kind == "many_idat":
        data = p.read_bytes()
        assert data.count(b"IDAT") > 3
    check(p)


@pytest.mark.parametrize("kind", ["LA", "1", "I16", "P1", "P2", "P4", "P8"])
def test_pil_written(tmp_path, kind):
    p = tmp_path / "f" / "0001.png"
    p.parent.mkdir()
    if kind == "LA":
        im = Image.fromarray(rand(0, (H, W, 2)), "LA")
        im.save(p)
    elif kind == "1":
        im = Image.fromarray(rand(1, (H, W), 2).astype(bool))
        im.save(p)
    elif kind == "I16":
        im = Image.fromarray(rand(2, (H, W), 65536, np.uint16))
        im.save(p)
    else:
        bits = int(kind[1:])
        colors = 1 << bits
        im = Image.fromarray(rand(3, (H, W), colors), "P")
        im.putpalette(rand(4, (colors * 3,)).tolist())
        im.save(p, bits=bits, transparency=1)
    data = p.read_bytes()
    ihdr = struct.unpack(">IIBB", data[16:26])
    expect = {"LA": (8, 4), "1": (1, 0), "I16": (16, 0), "P1": (1, 3),
              "P2": (2, 3), "P4": (4, 3), "P8": (8, 3)}[kind]
    assert ihdr[2:] == expect
    check(p)


ENCODED = [  # (name, depth, colour type, channels)
    ("grey1", 1, 0, 1), ("grey2", 2, 0, 1), ("grey4", 4, 0, 1),
    ("grey8", 8, 0, 1), ("grey16", 16, 0, 1), ("rgb8", 8, 2, 3),
    ("rgb16", 16, 2, 3), ("pal1", 1, 3, 1), ("pal2", 2, 3, 1),
    ("pal4", 4, 3, 1), ("pal8", 8, 3, 1), ("greya8", 8, 4, 2),
    ("greya16", 16, 4, 2), ("rgba8", 8, 6, 4), ("rgba16", 16, 6, 4)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("name,depth,ctype,c", ENCODED)
def test_encoded_every_filter(tmp_path, name, depth, ctype, c, interlace):
    hi = 1 << depth
    samples = rand(7, (H, W, c), hi, np.uint16 if depth == 16 else np.uint8)
    palette = rand(8, (hi, 3)) if ctype == 3 else None
    p = tmp_path / "f" / "0001.png"
    p.parent.mkdir()
    p.write_bytes(encode(samples, depth, ctype, palette=palette,
                         interlace=interlace))
    check(p)


def test_load_frames_matches_flair_tpu(tmp_path):
    from flair_tpu_torch.cli import load_frames

    d = tmp_path / "clip"
    d.mkdir()
    names = ["f10.png", "f2.png", "f1.png", "f33.png"]
    cv2.imwrite(str(d / names[0]), rand(0, (H, W, 3)))
    cv2.imwrite(str(d / names[1]), rand(1, (H, W), 65536, np.uint16))
    Image.fromarray(rand(2, (H, W, 2)), "LA").save(d / names[2])
    (d / names[3]).write_bytes(encode(rand(3, (H, W, 3)), 8, 2,
                                      interlace=True))
    ours, ref = load_frames(str(d)), j_load_frames(str(d))
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape", [(1, 1, 3), (H, W, 3), (64, 48, 3)])
def test_written_png_reads_back_in_cv2(tmp_path, shape):
    img = rand(9, shape)
    p = tmp_path / "out.png"
    png.write_png(str(p), img)
    back = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1], img)
    np.testing.assert_array_equal(png.read_png(str(p)), img)


def test_bad_crc_raises(tmp_path):
    data = bytearray(png.encode_png(rand(10, (8, 8, 3))))
    i = data.index(b"IDAT")
    data[i + 6] ^= 0x01          # one bit of the compressed stream
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
