"""The port's image reader and StyleExtractor against dhg's, on the CPU.

(c) read_img against dhg's cv2 path on cv2-written grey and RGB PNGs, bar
+-1 grey level; the PNG decoder bit-exact on every filter type and every
colour type it takes (files written here by a small reference encoder and
by cv2), and a ValueError naming what it refuses. (d) StyleExtractor
against dhg's on the same 96x192 array with data/style_trunk_synth.npz on
both sides: max |diff| <= 1e-4 in float32. dhg's side applies its flax
module to the .npz variables directly, skipping the random init that
init_style_extractor compiles before loading.
"""

import struct
import zlib
from pathlib import Path

import cv2
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.data.images import read_img as jax_read_img
from dhg.models.style_extractor import StyleExtractor as JaxStyleExtractor
from dhg_torch.data import images
from dhg_torch.models.style_extractor import init_style_extractor
from dhg_torch.weights import style_state_dict_from_flat

SYNTH = Path(__file__).resolve().parents[1] / "data" / "style_trunk_synth.npz"


def _line_image(rng, h=60, w=230):
    """A white page with dark scribbles, grey levels 0..255."""
    img = np.full((h, w), 235, np.uint8) + rng.randint(0, 20, (h, w)).astype(np.uint8)
    for _ in range(12):
        r, c = rng.randint(8, h - 8), rng.randint(8, w - 30)
        img[r - 2:r + 3, c:c + rng.randint(5, 25)] = rng.randint(0, 90)
    return img


@pytest.mark.parametrize("colour", ["grey", "rgb"])
def test_read_img_matches_dhg(tmp_path, colour):
    rng = np.random.RandomState(0 if colour == "grey" else 1)
    img = _line_image(rng)
    if colour == "rgb":
        img = np.stack([img, np.clip(img.astype(int) + rng.randint(-30, 30, img.shape), 0, 255),
                        img[::-1]], axis=-1).astype(np.uint8)
    path = str(tmp_path / "style.png")
    cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
    for height in (96, 40):
        ref = jax_read_img(path, height).astype(int)
        ours = images.read_img(path, height)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        assert np.abs(ours.astype(int) - ref).max() <= 1


def _png(samples, colour, depth=8, filters=(0, 1, 2, 3, 4), palette=None):
    """A reference PNG encoder: row y uses filter filters[y % len]."""
    h = samples.shape[0]
    if depth < 8:
        bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    else:
        rows = samples.reshape(h, -1).astype(np.uint8)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    bpp = max(1, channels * depth // 8)
    raw, prior = b"", np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw += bytes([ft]) + ((row - pred) & 255).astype(np.uint8).tobytes()
        prior = row

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    w = samples.shape[1]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    out = images.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("colour,depth", [(0, 8), (0, 1), (0, 2), (0, 4), (2, 8), (3, 8),
                                          (3, 4), (3, 2), (3, 1), (4, 8), (6, 8)])
def test_png_decoder_is_exact(tmp_path, colour, depth):
    """Every filter type on every row pattern; grey values of low-depth grey
    scale to 8 bits; palettes expand; and cv2 reads the same grey."""
    rng = np.random.RandomState(colour * 10 + depth)
    h, w = 11, 13
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    samples = rng.randint(0, 1 << depth, (h, w, channels)).astype(np.uint8)
    palette = rng.randint(0, 256, (1 << depth, 3)) if colour == 3 else None
    path = tmp_path / "x.png"
    path.write_bytes(_png(samples, colour, depth, palette=palette))
    got = images.read_png(path)
    if colour == 3:
        want = palette[samples[..., 0]].astype(np.uint8)
    elif colour == 0 and depth < 8:
        want = samples * (255 // ((1 << depth) - 1))
    else:
        want = samples
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(images.to_grey(got), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_png_decoder_reads_cv2_files_and_refuses_others(tmp_path):
    rng = np.random.RandomState(5)
    for shape in ((17, 23), (17, 23, 3), (17, 23, 4)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / "c.png")
        cv2.imwrite(path, img)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)  # BGR(A)
        if want.ndim == 3:
            want = want[..., [2, 1, 0, 3][:want.shape[-1]]]
        np.testing.assert_array_equal(images.read_png(path).reshape(img.shape), want)
    cv2.imwrite(str(tmp_path / "deep.png"), rng.randint(0, 65535, (4, 4)).astype(np.uint16))
    cv2.imwrite(str(tmp_path / "photo.jpg"), rng.randint(0, 256, (8, 8)).astype(np.uint8))
    inter = bytearray(_png(rng.randint(0, 256, (3, 3, 1)), 0))
    inter[28] = 1  # IHDR's interlace byte, then its CRC
    inter[29:33] = struct.pack(">I", zlib.crc32(bytes(inter[12:29])))
    (tmp_path / "inter.png").write_bytes(bytes(inter))
    bad_crc = bytearray(inter)
    bad_crc[30] ^= 1
    (tmp_path / "crc.png").write_bytes(bytes(bad_crc))
    for name, match in (("deep.png", "16-bit grey"), ("photo.jpg", "not a PNG"),
                        ("inter.png", "interlaced"), ("crc.png", "CRC")):
        with pytest.raises(ValueError, match=match):
            images.read_png(tmp_path / name)


@pytest.fixture(scope="module")
def flat():
    with np.load(SYNTH) as f:
        return dict(f)


def test_style_extractor_matches_dhg(flat):
    img = np.random.RandomState(3).uniform(0, 255, (2, 96, 192)).astype(np.float32)
    variables = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    ref = np.asarray(jax.jit(JaxStyleExtractor().apply)(variables, img))
    model = init_style_extractor(SYNTH, device="cpu")
    with torch.no_grad():
        ours = model(torch.from_numpy(img)).numpy()
    assert ours.shape == ref.shape == (2, 14, 1280) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-4


def test_style_weights_map_every_entry(flat):
    sd = style_state_dict_from_flat(flat)
    assert len(flat) == 260
    assert sum(not k.endswith("num_batches_tracked") for k in sd) == 260
    dw = "params/mobilenet/block_1_0/dw/conv/kernel"
    assert flat[dw].shape[2] == 1
    np.testing.assert_array_equal(sd["mobilenet.block_1_0.dw.conv.weight"].numpy(),
                                  flat[dw].transpose(3, 2, 0, 1))
    with pytest.raises(KeyError, match="missing"):
        style_state_dict_from_flat({k: v for k, v in flat.items() if k != dw})
    with pytest.raises(KeyError, match="unexpected"):
        style_state_dict_from_flat(dict(flat, extra=np.zeros(1)))


def test_missing_weights_warn_or_raise(tmp_path):
    missing = tmp_path / "absent.npz"
    with pytest.warns(UserWarning, match="RANDOM-INITIALIZED"):
        a = init_style_extractor(missing, seed=1, device="cpu")
    with pytest.warns(UserWarning):
        b = init_style_extractor(missing, seed=1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    with pytest.raises(FileNotFoundError, match="not found"):
        init_style_extractor(missing, strict=True, device="cpu")
