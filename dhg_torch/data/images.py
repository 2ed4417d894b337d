"""Line-image loading and preprocessing (port of dhg/data/images.py), with
numpy and the standard library only: the card's machine has no cv2.

  * read_img: PNG -> 8-bit grey -> remove_whitespace(thresh=127) -> bicubic
    resize to the target height, preserving the aspect ratio;
  * remove_whitespace: crop to the rows/cols holding a pixel below the
    threshold, with dhg's quirk (the last dark row and col are excluded);
  * pad_img: right-pad with white (255) to a fixed width;
  * read_png / write_png: a PNG codec on zlib and struct.

What dhg's cv2 calls do, and what this module does in their place:
  * cv2.imread(IMREAD_GRAYSCALE) reads through libpng with
    png_set_rgb_to_gray(0.299, 0.587): colour pixels become
    (9797 R + 19234 G + 3737 B) >> 15, grey ones keep their value, alpha is
    dropped, a palette is expanded first, and 1/2/4-bit grey is scaled to
    8 bits. read_png does the same for 8-bit grey, grey+alpha, RGB and RGBA,
    and for palettes and grey of 1, 2, 4 or 8 bits; non-interlaced, all
    five filter types. Any other file (16-bit, interlaced, not a PNG)
    raises ValueError naming what it is: a documented narrowing, since
    images are PNG only here.
  * cv2.resize(INTER_CUBIC) on uint8: cubic weights with a = -0.75 at
    source position (d + 0.5) * src / dst - 0.5, replicated borders, a
    horizontal then a vertical pass, rounded back to uint8. resize_cubic
    does the same in float64 (cv2 5.0 agrees on all but about one pixel in
    50,000, by one grey level).
"""

from __future__ import annotations

import struct
import zlib
from os import PathLike

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


def remove_whitespace(img: np.ndarray, thresh: float) -> np.ndarray:
    """Crop to the dark-pixel bounding box, exclusive of the last dark
    row/col (dhg's quirk: img[r0:r_last, c0:c_last])."""
    dark = img < thresh
    row_has = dark.any(axis=1)
    col_has = dark.any(axis=0)
    r0 = int(np.argmax(row_has))
    r1 = len(row_has) - 1 - int(np.argmax(row_has[::-1]))
    c0 = int(np.argmax(col_has))
    c1 = len(col_has) - 1 - int(np.argmax(col_has[::-1]))
    return img[r0:r1, c0:c1]


def _chunks(data: bytes, path):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _paeth_or_average(line: bytes, prior: bytes, bpp: int, paeth: bool) -> bytes:
    cur = bytearray(len(line))
    for i, v in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if paeth:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (v + pred) & 255
    return bytes(cur)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    out = np.zeros((height, stride), np.uint8)
    prior = bytes(stride)
    for y in range(height):
        pos = y * (stride + 1)
        ftype, line = raw[pos], raw[pos + 1:pos + 1 + stride]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            # Sub: a running sum over pixels, byte lane by byte lane.
            lanes = np.frombuffer(line, np.uint8).astype(np.int64).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) & 255).astype(np.uint8).tobytes()
        elif ftype == 2:
            cur = ((np.frombuffer(line, np.uint8).astype(np.int64)
                    + np.frombuffer(prior, np.uint8)) & 255).astype(np.uint8).tobytes()
        elif ftype in (3, 4):
            cur = _paeth_or_average(line, prior, bpp, paeth=ftype == 4)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {ftype}")
        out[y] = np.frombuffer(cur, np.uint8)
        prior = cur
    return out


def _unpack(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Rows of packed 1/2/4-bit samples -> [H, width] values, MSB first."""
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1).astype(np.uint8)


def read_png(path: PathLike | str) -> np.ndarray:
    """The PNG at `path` as uint8 samples [H, W, C]: C = 1 grey, 2 grey +
    alpha, 3 RGB (palettes expanded), 4 RGBA. Raises ValueError on anything
    this decoder does not take, naming it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        kind = data[:4]
        raise ValueError(f"{path}: not a PNG file (starts {kind!r}); only PNG images are read")
    header, idat, palette = None, [], None
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    name = _COLOUR_NAMES[colour]
    if interlace:
        raise ValueError(f"{path}: interlaced PNG ({name}) is not supported")
    if depth == 16 or (depth != 8 and colour not in (0, 3)):
        raise ValueError(f"{path}: {depth}-bit {name} PNG is not supported (8-bit only)")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[colour]
    bpp = max(1, channels * depth // 8)
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, bpp, path)
    if depth < 8:
        samples = _unpack(rows, width, depth)
        if colour == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    else:
        samples = rows.reshape(height, width, channels)
    if colour == 3:
        return palette[samples.reshape(height, width)]
    return samples.reshape(height, width, channels)


def to_grey(samples: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 -> [H, W] grey, as libpng's rgb_to_gray(0.299, 0.587)
    does for cv2: alpha dropped, grey pixels kept exactly."""
    if samples.shape[-1] <= 2:
        return samples[..., 0].copy()
    rgb = samples[..., :3].astype(np.int64)
    # The weights sum to 2^15, so a grey pixel keeps its value.
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2]) >> 15).astype(np.uint8)


def write_png(path: PathLike | str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] (grey) or [H, W, 3] (RGB) array as a PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3] uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body)
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _cubic_taps(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """Cubic interpolation (a = -0.75) along one axis: for each output index,
    the 4 source indices (replicated at the borders) and their weights."""
    fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    weights = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=1)
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, weights


def resize_cubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bicubic resize of a uint8 [H, W] image to [height, width], as
    cv2.resize(INTER_CUBIC): a horizontal then a vertical pass in float64,
    rounded to the nearest integer and clipped to uint8."""
    h, w = img.shape
    if (h, w) == (height, width):
        return img.copy()
    xi, xw = _cubic_taps(width, w)
    yi, yw = _cubic_taps(height, h)
    rows = (img.astype(np.float64)[:, xi] * xw[None]).sum(axis=-1)  # [h, width]
    out = (rows[yi] * yw[:, :, None]).sum(axis=1)  # [height, width]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def read_img(path: PathLike | str, height: int) -> np.ndarray:
    """A style image: grey, cropped to its ink, resized to `height` rows."""
    img = remove_whitespace(to_grey(read_png(path)), thresh=127)
    h, w = img.shape
    return resize_cubic(img, height * w // h, height)


def pad_img(img: np.ndarray, width: int, height: int) -> np.ndarray:
    pad_len = width - img.shape[1]
    whites = np.ones((height, pad_len)) * 255
    return np.concatenate([img, whites], axis=1).astype("float32")
