"""Line-image loading and preprocessing (port of dhg/data/images.py), with
numpy and the standard library only: the card's machine has no cv2.

  * read_img: PNG or TIFF -> 8-bit grey -> remove_whitespace(thresh=127) ->
    bicubic resize to the target height, preserving the aspect ratio;
  * remove_whitespace: crop to the rows/cols holding a pixel below the
    threshold, with dhg's quirk (the last dark row and col are excluded);
  * pad_img: right-pad with white (255) to a fixed width;
  * read_png / write_png: a PNG codec on zlib and struct;
  * read_tiff / write_tiff: a TIFF reader of the baseline formats (IAM's line
    images are TIFF) and a baseline grey writer.

What dhg's cv2 calls do, and what this module does in their place:
  * cv2.imread(IMREAD_GRAYSCALE) reads through libpng with
    png_set_rgb_to_gray(0.299, 0.587): colour pixels become
    (9797 R + 19234 G + 3737 B) >> 15, grey ones keep their value, alpha is
    dropped, a palette is expanded first, and 1/2/4-bit grey is scaled to
    8 bits. read_png does the same for 8-bit grey, grey+alpha, RGB and RGBA,
    and for palettes and grey of 1, 2, 4 or 8 bits; non-interlaced, all
    five filter types. Any other PNG (16-bit, interlaced) raises ValueError
    naming what it is: a documented narrowing.
  * cv2 reads a TIFF through libtiff's RGBA interface, then imgcodecs'
    fixed-point BGR -> grey. read_tiff gives the same grey for the formats
    it takes (see its docstring) and raises ValueError naming the tag and
    its value for any other: also a documented narrowing.
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
        raise ValueError(f"{path}: not a PNG file (starts {kind!r}); read_img takes PNG or TIFF")
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


# -- TIFF -------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}  # the integer field types
_TIFF_TAG_NAMES = {
    259: "Compression", 262: "PhotometricInterpretation",
    258: "BitsPerSample", 266: "FillOrder", 274: "Orientation", 277: "SamplesPerPixel",
    284: "PlanarConfiguration", 317: "Predictor", 322: "TileWidth", 338: "ExtraSamples",
    339: "SampleFormat",
}
_TIFF_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}


def _tiff_refuse(path, tag: int, value) -> ValueError:
    return ValueError(f"{path}: TIFF {_TIFF_TAG_NAMES.get(tag, tag)} (tag {tag}) = {value} "
                      "is not supported")


def _tiff_tags(data: bytes, path) -> tuple[str, dict[int, list[int]]]:
    """The byte order and the integer tags of the first image directory."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise ValueError(f"{path}: not a TIFF file")
    (magic,) = struct.unpack(order + "H", data[2:4])
    if magic == 43:
        raise ValueError(f"{path}: BigTIFF is not supported")
    if magic != 42:
        raise ValueError(f"{path}: not a TIFF file (magic {magic})")
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags: dict[int, list[int]] = {}
    for k in range(n):
        tag, typ, count, field = struct.unpack(order + "HHI4s", data[ifd + 2 + 12 * k:
                                                                     ifd + 14 + 12 * k])
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:  # text, rationals, floats: no tag read here needs them
            continue
        size = struct.calcsize(fmt) * count
        if size <= 4:
            raw = field[:size]
        else:
            (off,) = struct.unpack(order + "I", field)
            raw = data[off:off + size]
        tags[tag] = list(struct.unpack(order + fmt * count, raw))
    return order, tags


def _lzw_decode(data: bytes, path) -> bytes:
    """TIFF LZW: codes MSB first, 9 to 12 bits, the width growing one code
    early (at 511, 1023, 2047), 256 clears the table, 257 ends."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError(f"{path}: old-style (pre-6.0) TIFF LZW is not supported")
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    buf = nbits = pos = 0
    width, prev = 9, None
    n = len(data)
    while True:
        while nbits < width:
            if pos >= n:
                return bytes(out)
            buf = ((buf << 8) | data[pos]) & 0xFFFFFF
            pos += 1
            nbits += 8
        nbits -= width
        code = (buf >> nbits) & ((1 << width) - 1)
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:
            return bytes(out)
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"{path}: corrupt LZW data (code {code})")
            table.append(prev + entry[:1])
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        out += entry
        prev = entry


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n:
        h = data[pos]
        pos += 1
        if h < 128:  # the next h + 1 bytes as they are
            out += data[pos:pos + h + 1]
            pos += h + 1
        elif h > 128:  # the next byte 257 - h times
            out += data[pos:pos + 1] * (257 - h)
            pos += 1
    return bytes(out)


def read_tiff(path: PathLike | str) -> np.ndarray:
    """The first image of the TIFF at `path` as uint8 grey [H, W], as
    cv2.imread(path, IMREAD_GRAYSCALE) reads it through libtiff.

    Takes either byte order; strips (not tiles); compression none, LZW (with
    or without the horizontal-differencing predictor), PackBits and Deflate;
    1-bit bilevel (WhiteIsZero or BlackIsZero), 8-bit grey, 8-bit RGB and
    RGBA, chunky. Colour becomes grey by imgcodecs' fixed-point rule
    (4899 R + 9617 G + 1868 B + 8192) >> 14; libtiff first premultiplies
    unassociated alpha (ExtraSamples = 2), (v a + 127) // 255, and drops
    any fourth sample. Anything else
    raises ValueError naming the tag and its value."""
    with open(path, "rb") as f:
        data = f.read()
    order, tags = _tiff_tags(data, path)

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]

    if 322 in tags or 324 in tags:
        raise ValueError(f"{path}: tiled TIFF (TileWidth = {one(322)}) is not supported")
    width, height = one(256), one(257)
    spp, photometric = one(277, 1), one(262)
    bits = set(tags.get(258, [1]))
    compression, predictor = one(259, 1), one(317, 1)
    for tag, ok in ((266, (1,)), (274, (1,)), (284, (1,)), (339, (1,))):
        if one(tag, 1) not in ok:
            raise _tiff_refuse(path, tag, one(tag))
    if compression not in _TIFF_COMPRESSIONS:
        raise _tiff_refuse(path, 259, compression)
    if photometric in (0, 1) and spp == 1 and bits <= {1, 8} and len(bits) == 1:
        depth = bits.pop()
    elif photometric == 2 and spp in (3, 4) and bits == {8}:
        depth = 8
        if spp == 4 and one(338, 0) not in (0, 1, 2):
            raise _tiff_refuse(path, 338, one(338))
    elif photometric not in (0, 1, 2):
        raise _tiff_refuse(path, 262, photometric)
    elif bits != {8} and bits != {1}:
        raise _tiff_refuse(path, 258, sorted(bits) if len(bits) > 1 else bits.pop())
    else:
        raise _tiff_refuse(path, 277, spp)
    if predictor not in (1, 2) or (predictor == 2 and depth != 8):
        raise _tiff_refuse(path, 317, predictor)

    stride = (width * spp * depth + 7) // 8
    raw = bytearray()
    for off, size in zip(tags[273], tags[279]):
        strip = data[off:off + size]
        if compression == 5:
            strip = _lzw_decode(strip, path)
        elif compression == 32773:
            strip = _packbits_decode(strip)
        elif compression in (8, 32946):
            strip = zlib.decompress(strip)
        raw += strip
    if len(raw) < stride * height:
        raise ValueError(f"{path}: TIFF image data is truncated")
    rows = np.frombuffer(bytes(raw[:stride * height]), np.uint8).reshape(height, stride)
    if depth == 1:
        grey = np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
        return 255 - grey if photometric == 0 else grey
    px = rows.reshape(height, width, spp)
    if predictor == 2:
        px = (np.cumsum(px, axis=1, dtype=np.int64) & 255).astype(np.uint8)
    if photometric == 0:
        return 255 - px[..., 0]
    if spp == 1:
        return px[..., 0].copy()
    rgb = px[..., :3].astype(np.int64)
    if spp == 4 and one(338) == 2:  # unassociated alpha: premultiply
        rgb = (rgb * px[..., 3:4].astype(np.int64) + 127) // 255
    return ((4899 * rgb[..., 0] + 9617 * rgb[..., 1] + 1868 * rgb[..., 2] + 8192) >> 14
            ).astype(np.uint8)


def write_tiff(path: PathLike | str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] grey array as a baseline TIFF: little-endian,
    uncompressed, one strip, BlackIsZero."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"write_tiff takes [H, W] uint8, got {img.shape}")
    h, w = img.shape
    body = img.tobytes()
    ifd = 8 + len(body) + (len(body) & 1)
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8), (259, 3, 1, 1),
               (262, 3, 1, 1), (273, 4, 1, 8), (277, 3, 1, 1), (278, 4, 1, h),
               (279, 4, 1, len(body)), (282, 5, 1, ifd + 6 + 12 * 12),
               (283, 5, 1, ifd + 6 + 12 * 12 + 8), (296, 3, 1, 2)]
    out = bytearray(b"II*\x00" + struct.pack("<I", ifd) + body)
    out += b"\x00" * (ifd - len(out))
    out += struct.pack("<H", len(entries))
    for tag, typ, count, value in entries:
        fmt = "<HHIH2x" if typ == 3 else "<HHII"
        out += struct.pack(fmt, tag, typ, count, value)
    out += struct.pack("<I", 0) + struct.pack("<IIII", 72, 1, 72, 1)
    with open(path, "wb") as f:
        f.write(bytes(out))


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


def _resize_cubic_f64(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """A horizontal then a vertical cubic pass in float64."""
    h, w = img.shape
    xi, xw = _cubic_taps(width, w)
    yi, yw = _cubic_taps(height, h)
    src = img.astype(np.float64)
    # Tap by tap: four gathers of [h, width], summed in the taps' order.
    rows = src[:, xi[:, 0]] * xw[:, 0]
    for k in range(1, 4):
        rows += src[:, xi[:, k]] * xw[:, k]  # [h, width]
    out = rows[yi[:, 0]] * yw[:, 0, None]
    for k in range(1, 4):
        out += rows[yi[:, k]] * yw[:, k, None]
    return out  # [height, width]


def resize_cubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bicubic resize of a uint8 [H, W] image to [height, width], as
    cv2.resize(INTER_CUBIC): a horizontal then a vertical pass in float64,
    rounded to the nearest integer and clipped to uint8."""
    if img.shape == (height, width):
        return img.copy()
    return np.clip(np.rint(_resize_cubic_f64(img, width, height)), 0, 255).astype(np.uint8)


def resize_cubic_float(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """The same resize of a float image, as cv2.resize(INTER_CUBIC) on
    float32: float32 out, neither rounded nor clipped."""
    if img.shape == (height, width):
        return img.astype(np.float32)
    return _resize_cubic_f64(img, width, height).astype(np.float32)


def read_grey(path: PathLike | str) -> np.ndarray:
    """The image at `path` as uint8 grey [H, W], as cv2.imread(path,
    IMREAD_GRAYSCALE) gives it: a TIFF through read_tiff, else a PNG."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return read_tiff(path)
    return to_grey(read_png(path))


def read_img(path: PathLike | str, height: int) -> np.ndarray:
    """A line image (PNG or TIFF): grey, cropped to its ink, resized to
    `height` rows."""
    img = remove_whitespace(read_grey(path), thresh=127)
    h, w = img.shape
    return resize_cubic(img, height * w // h, height)


def pad_img(img: np.ndarray, width: int, height: int) -> np.ndarray:
    pad_len = width - img.shape[1]
    whites = np.ones((height, pad_len)) * 255
    return np.concatenate([img, whites], axis=1).astype("float32")
