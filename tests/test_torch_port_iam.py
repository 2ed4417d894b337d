"""The port's IAM data path against dhg's, on the CPU.

Stroke XML parsing (the native scanner and the ElementTree path, each bit
for bit with dhg's; stroke_ops.cpp byte for byte dhg's); read_tiff exactly
as cv2.imread(IMREAD_GRAYSCALE) on files written by cv2 (LZW with predictor
2) and by PIL (none, PackBits, Deflate; bilevel, grey, RGB, RGBA; either
byte order), and a ValueError naming the tag on each format it does not
take; read_img on a .tif within one grey level of dhg's; build_iam_cache
on a two-form tree against dhg's (same sample ids, texts, strokes and drops;
styles from one stub function of the image, within one grey level), serial
and threaded builds identical; each package loading the other's cache file
without a rebuild; extract_style_vectors against dhg's with the same
MobileNetV2 weights within 1e-4, a wide image bucketed; load_cache with
dataset iam feeding a train step; gen_iam_scale's text and XML byte for
byte dhg's at one seed. No test builds dhg's style extractor or model.
"""

import json
import struct
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
PIL_Image = pytest.importorskip("PIL.Image")
PIL_Tiff = pytest.importorskip("PIL.TiffImagePlugin")

import dhg.data.iam as jax_iam  # noqa: E402
import dhg.native as jax_native  # noqa: E402
from dhg.data.images import read_img as jax_read_img  # noqa: E402
from dhg.data.strokes import parse_strokes_xml as jax_parse  # noqa: E402
from dhg.models.style_extractor import StyleExtractor as JaxStyleExtractor  # noqa: E402
from dhg_torch import config as cf  # noqa: E402
from dhg_torch import native  # noqa: E402
from dhg_torch import train as tr  # noqa: E402
from dhg_torch.data import iam, images, strokes  # noqa: E402

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

ROOT = Path(__file__).resolve().parents[1]
SYNTH = ROOT / "data" / "style_trunk_synth.npz"
BUILD = dict(img_height=96, img_width=1400, max_text_len=50, max_seq_len=480, seed=54321)


def _stroke_xml(points_per_stroke, start=(100, 200), step=8, seed=0):
    """An IAM-structured stroke file; coordinates walk right with jitter."""
    rng = np.random.RandomState(seed)
    x, y = start
    parts = []
    for n in points_per_stroke:
        pts = []
        for _ in range(n):
            x += step + int(rng.randint(-2, 3))
            y += int(rng.randint(-3, 4))
            pts.append(f'<Point x="{x}" y="{y}" time="0"/>')
        parts.append("<Stroke>" + "".join(pts) + "</Stroke>")
    return ("<WhiteboardCaptureSession><StrokeSet>" + "".join(parts)
            + "</StrokeSet></WhiteboardCaptureSession>")


def _line_image(width=420, height=140, seed=0):
    img = np.full((height, width), 255, np.uint8)
    rng = np.random.RandomState(seed)
    xs = np.linspace(15, width - 15, 300).astype(int)
    ys = (height // 2 + 25 * np.sin(xs / 17.0) + rng.randn(300) * 2).astype(int)
    img[np.clip(ys, 2, height - 3), xs] = 0
    img[np.clip(ys + 1, 2, height - 3), xs] = 90
    return img


def stub_style(b):
    """One fixed function of the image for both packages: each of 14 column
    bins' mean grey times a fixed ramp."""
    b = np.asarray(b, np.float32)
    v = np.zeros((b.shape[0], 14, 1280), np.float32)
    for i, cols in enumerate(np.array_split(np.arange(b.shape[2]), 14)):
        v[:, i, :] = b[:, :, cols].mean(axis=(1, 2))[:, None] * np.linspace(0, 1, 1280)[None]
    return v


@pytest.fixture(scope="module")
def iam_tree(tmp_path_factory):
    """Two forms in IAM's layout, cv2-written TIFFs; form 1 has a line for
    each drop filter (text too long, strokes too long, image too wide)."""
    root = tmp_path_factory.mktemp("iam")
    forms = ["a01-000u", "b02-011"]
    texts = ["A first line", "And another one", "Third text here",
             "x" * 50, "a line with long strokes", "a line with a wide image"]
    for fi, form in enumerate(forms):
        d1, d2 = form[:3], form[:7]
        for sub in ("ascii", "lineStrokes", "lineImages"):
            (root / sub / d1 / d2).mkdir(parents=True)
        n = 6 if fi == 0 else 3
        (root / "ascii" / d1 / d2 / f"{form}.txt").write_text(
            "OCR:\n\nx\n\nCSR:\n\n" + "\n".join(texts[:n]) + "\n")
        for i in range(1, n + 1):
            sid = f"{form}-{i:02d}"
            sizes = [700, 600, 700] if i == 5 else [30, 40, 25]
            (root / "lineStrokes" / d1 / d2 / f"{sid}.xml").write_text(
                _stroke_xml(sizes, step=5 + ((fi + i) % 4), seed=10 * fi + i))
            img = _line_image(width=2200 if i == 6 else 420 + 40 * i, seed=10 * fi + i)
            cv2.imwrite(str(root / "lineImages" / d1 / d2 / f"{sid}.tif"), img)
    splits = root / "splits.json"
    splits.write_text(json.dumps({"train": forms, "validation": forms[1:]}))
    return root, splits


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(native, "get_lib", lambda: None)


def test_stroke_ops_cpp_is_dhgs():
    assert native.SRC.read_bytes() == (ROOT / "dhg" / "native" / "stroke_ops.cpp").read_bytes()


@pytest.mark.parametrize("route", ["native", "fallback"])
def test_parse_strokes_xml_matches_dhg(tmp_path, iam_tree, route, request):
    if route == "native":
        assert native.get_lib() is not None and jax_native.get_lib() is not None
    else:
        request.getfixturevalue("no_native")
    root, _ = iam_tree
    paths = sorted(root.glob("lineStrokes/*/*/*.xml"))
    odd = tmp_path / "odd.xml"  # the scanner declines a repeated attribute
    odd.write_text('<S><StrokeSet><Stroke><Point x="1" y="2"/><Point x="4" y="3" x="5"/>'
                   '<Point x="7" y="9"/></Stroke></StrokeSet></S>')
    strokes.parsed.clear()
    for p in paths:
        ours, ref = strokes.parse_strokes_xml(p), jax_parse(p)
        assert ours.shape == ref.shape and np.array_equal(ours, ref)
    assert dict(strokes.parsed) == {route: len(paths)}
    with pytest.raises(Exception) as ours_err:
        strokes.parse_strokes_xml(odd)
    with pytest.raises(Exception) as ref_err:
        jax_parse(odd)
    assert type(ours_err.value) is type(ref_err.value)


# -- TIFF ---------------------------------------------------------------------


def _tags(path):
    return images._tiff_tags(Path(path).read_bytes(), path)[1]


def test_read_tiff_reads_cv2_files_exactly(tmp_path):
    rng = np.random.RandomState(0)
    cases = {"line": _line_image(seed=3), "noise": rng.randint(0, 256, (57, 91)),
             "rgb": rng.randint(0, 256, (37, 53, 3)), "rgba": rng.randint(0, 256, (37, 53, 4))}
    for name, img in cases.items():
        path = str(tmp_path / f"{name}.tif")
        cv2.imwrite(path, img.astype(np.uint8))
        tags = _tags(path)
        assert tags[259] == [5] and tags[317] == [2]  # LZW, horizontal differencing
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(images.read_tiff(path), want)


@pytest.mark.parametrize("compression", [None, "packbits", "tiff_deflate", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["1", "L", "RGB", "RGBA"])
def test_read_tiff_reads_pil_files_exactly(tmp_path, compression, mode):
    rng = np.random.RandomState(len(mode))
    shape = (29, 37, len(mode)) if len(mode) > 1 else (29, 37)
    arr = rng.randint(0, 256, shape).astype(np.uint8)
    img = PIL_Image.fromarray(arr > 100) if mode == "1" else PIL_Image.fromarray(arr, mode)
    path = str(tmp_path / "p.tif")
    img.save(path, **({} if compression is None else {"compression": compression}))
    want = {None: 1, "packbits": 32773, "tiff_deflate": 8, "tiff_adobe_deflate": 8}[compression]
    assert _tags(path)[259] == [want]
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(images.read_tiff(path), want)


def test_read_tiff_byte_orders_photometrics_and_pages(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    arr = rng.randint(0, 256, (23, 31)).astype(np.uint8)
    for key, mode, photometric, order in (("L", "L", 1, b"MM"), ("1", "1", 0, b"MM"),
                                          ("L", "L", 0, b"II")):
        monkeypatch.setitem(PIL_Tiff.SAVE_INFO, key,
                            (mode, order, photometric, 1, (1 if mode == "1" else 8,), None))
        path = str(tmp_path / f"{mode}{photometric}.tif")
        PIL_Image.fromarray(arr > 100 if mode == "1" else arr).save(path)
        assert Path(path).read_bytes()[:2] == order and _tags(path)[262] == [photometric]
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(images.read_tiff(path), want)
    monkeypatch.undo()
    path = str(tmp_path / "pages.tif")
    PIL_Image.fromarray(arr).save(path, save_all=True,
                                  append_images=[PIL_Image.fromarray(255 - arr)])
    np.testing.assert_array_equal(images.read_tiff(path), arr)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(images.read_tiff(path), want)


def _retag(path, old_tag, new_tag, value=None):
    """Rename one directory entry (and optionally set its short value)."""
    data = bytearray(Path(path).read_bytes())
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd:ifd + 2])
    for k in range(n):
        pos = ifd + 2 + 12 * k
        if struct.unpack("<H", data[pos:pos + 2])[0] == old_tag:
            data[pos:pos + 2] = struct.pack("<H", new_tag)
            if value is not None:
                data[pos + 8:pos + 10] = struct.pack("<H", value)
    Path(path).write_bytes(bytes(data))


def test_read_tiff_refuses_by_name(tmp_path):
    rng = np.random.RandomState(2)
    arr = rng.randint(0, 256, (9, 11)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "deep.tif"), rng.randint(0, 65535, (5, 5)).astype(np.uint16))
    PIL_Image.fromarray(arr).convert("P").save(tmp_path / "palette.tif")
    PIL_Image.fromarray(np.stack([arr, arr], -1), "LA").save(tmp_path / "grey_alpha.tif")
    PIL_Image.fromarray(np.stack([arr] * 3, -1)).save(tmp_path / "jpeg.tif", compression="jpeg")
    PIL_Image.fromarray(arr.astype(np.float32)).save(tmp_path / "float.tif")
    PIL_Image.fromarray(np.stack([arr] * 4, -1)).convert("CMYK").save(tmp_path / "cmyk.tif")
    for name in ("tiled", "planar", "predictor", "fill"):
        images.write_tiff(tmp_path / f"{name}.tif", arr)
    _retag(tmp_path / "tiled.tif", 278, 322)  # RowsPerStrip -> TileWidth
    for name, tag, value in (("planar", 284, 2), ("predictor", 317, 3), ("fill", 266, 2)):
        _retag(tmp_path / f"{name}.tif", 296, tag, value)  # ResolutionUnit -> tag
    (tmp_path / "big.tif").write_bytes(b"II+\x00" + bytes(12))
    (tmp_path / "not.tif").write_bytes(b"GIF89a" + bytes(10))
    for name, match in (("deep", r"BitsPerSample \(tag 258\) = 16"),
                        ("palette", r"PhotometricInterpretation \(tag 262\) = 3"),
                        ("grey_alpha", r"SamplesPerPixel \(tag 277\) = 2"),
                        ("jpeg", r"Compression \(tag 259\) = 7"),
                        ("float", r"SampleFormat \(tag 339\) = 3"),
                        ("cmyk", r"PhotometricInterpretation \(tag 262\) = 5"),
                        ("tiled", "tiled TIFF"),
                        ("planar", r"PlanarConfiguration \(tag 284\) = 2"),
                        ("predictor", r"Predictor \(tag 317\) = 3"),
                        ("fill", r"FillOrder \(tag 266\) = 2"),
                        ("big", "BigTIFF"), ("not", "not a TIFF")):
        with pytest.raises(ValueError, match=match):
            images.read_tiff(tmp_path / f"{name}.tif")


def test_write_tiff_reads_back_everywhere(tmp_path):
    for shape in ((7, 13), (8, 13)):
        arr = np.random.RandomState(shape[0]).randint(0, 256, shape).astype(np.uint8)
        path = tmp_path / f"w{shape[0]}.tif"
        images.write_tiff(path, arr)
        np.testing.assert_array_equal(images.read_tiff(path), arr)
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), arr)
        np.testing.assert_array_equal(np.asarray(PIL_Image.open(path)), arr)


def test_read_img_on_a_tif_matches_dhg(iam_tree):
    root, _ = iam_tree
    for path in sorted(root.glob("lineImages/*/*/*.tif"))[:4]:
        for height in (96, 40):
            ref = jax_read_img(str(path), height).astype(int)
            ours = images.read_img(path, height)
            assert ours.dtype == np.uint8 and ours.shape == ref.shape
            assert np.abs(ours.astype(int) - ref).max() <= 1


# -- the cache build ------------------------------------------------------------


def test_build_iam_cache_matches_dhg(iam_tree):
    root, splits = iam_tree
    kw = dict(data_dir=root, kind="train", splits_file=splits, **BUILD)
    ref = jax_iam.build_iam_cache(style_apply_fn=stub_style, workers=1, **kw)
    stats: dict = {}
    serial = iam.build_iam_cache(style_apply_fn=stub_style, workers=1, device="cpu",
                                 stats=stats, **kw)
    threaded = iam.build_iam_cache(style_apply_fn=stub_style, workers=4, device="cpu", **kw)
    assert serial.sample_ids == ref.sample_ids == [
        "a01-000u-01", "a01-000u-02", "a01-000u-03", "b02-011-01", "b02-011-02", "b02-011-03"]
    for ours in (serial, threaded):
        assert ours.sample_ids == ref.sample_ids
        for key in ("strokes", "text"):
            a, b = getattr(ours, key), getattr(ref, key)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ours.style.shape == ref.style.shape and ours.style.dtype == np.float32
        assert np.abs(ours.style - ref.style).max() <= 1.0  # one grey level
    np.testing.assert_array_equal(serial.style, threaded.style)
    assert (stats["dropped_text"], stats["dropped_strokes"], stats["dropped_image"],
            stats["kept"], stats["forms"]) == (1, 1, 1, 6, 2)
    trunc = iam.build_iam_cache(style_apply_fn=stub_style, workers=4, device="cpu",
                                max_files=4, **kw)
    assert trunc.sample_ids == ref.sample_ids[:4]


def test_caches_load_across_packages(iam_tree, tmp_path, monkeypatch):
    root, splits = iam_tree
    kw = dict(data_dir=root, kind="validation", splits_file=splits, **BUILD)
    a = jax_iam.load_or_build_cache(tmp_path / "a", style_apply_fn=stub_style, **kw)
    b = iam.load_or_build_cache(tmp_path / "b", style_apply_fn=stub_style, device="cpu", **kw)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == sorted(
        p.name for p in (tmp_path / "b").iterdir()) == [iam.cache_path(tmp_path, **kw).name]

    def no_build(**_):
        raise AssertionError("rebuilt instead of loading the saved cache")

    monkeypatch.setattr(iam, "build_iam_cache", no_build)
    monkeypatch.setattr(jax_iam, "build_iam_cache", no_build)
    stats: dict = {}
    ours = iam.load_or_build_cache(tmp_path / "a", style_apply_fn=stub_style, device="cpu",
                                   workers=3, stats=stats, **kw)
    theirs = jax_iam.load_or_build_cache(tmp_path / "b", style_apply_fn=stub_style, **kw)
    assert "loaded" in stats
    for got, want in ((ours, a), (theirs, b)):
        assert got.sample_ids == want.sample_ids
        for key in ("strokes", "text", "style"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    with np.load(iam.cache_path(tmp_path / "b", **kw), allow_pickle=False) as z:
        assert sorted(z.files) == ["sample_ids", "strokes", "style", "text"]


def test_extract_style_vectors_matches_dhg():
    with np.load(SYNTH) as f:
        flat = dict(f)
    variables = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    jax_apply = jax.jit(JaxStyleExtractor().apply)
    rng = np.random.RandomState(4)
    imgs = [rng.uniform(0, 255, (96, 256)).astype(np.float32) for _ in range(3)]
    imgs.append(rng.uniform(0, 255, (96, 1460)).astype(np.float32))  # -> bucket 1408
    seen = []

    def ref_fn(b):
        seen.append(np.shape(b))
        return np.asarray(jax_apply(variables, b))

    ref = jax_iam.extract_style_vectors(imgs, ref_fn, batch=3)
    ours = iam.extract_style_vectors(imgs, iam.style_apply(SYNTH, "cpu"), batch=3)
    assert seen == [(3, 96, 256), (1, 96, 1408)]
    assert ours.shape == ref.shape == (4, 14, 1280) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-4


def test_load_cache_iam_feeds_a_train_step(iam_tree, tmp_path):
    root, splits = iam_tree
    cfg = cf.DLConfig({
        "experiment": {"data_dir": str(root), "splits_file": str(splits), "seed": 3},
        "dataset_args": {"max_seq_len": 480, "max_text_len": 50},
        "optimizer": {"type": "torch.optim.Adam"},
        "training_args": {"dataset": "iam", "cache_dir": str(tmp_path), "channels": 16,
                          "att_layers_num": 1, "batch_size": 2, "warmup_steps": 10,
                          "compute_dtype": "float32"}})
    # Prebuilt with the stub: load_cache must find it by its fingerprint.
    built = iam.load_or_build_cache(**tr.iam_cache_kwargs(cfg, "train", "cpu"),
                                    style_apply_fn=stub_style)
    trainer = tr.Trainer(cfg, device="cpu")
    data = trainer.load_dataset()
    assert data.size == len(built) == 6
    np.testing.assert_array_equal(data.style.numpy(), built.style)
    losses = trainer.train_step(trainer.draw(1))
    assert losses.shape == (3,) and torch.isfinite(losses).all()


def test_gen_iam_scale_matches_dhg(tmp_path):
    from dhg.tools import gen_iam_scale as jax_gen
    from dhg_torch.tools import gen_iam_scale

    gen_iam_scale.main(root=str(tmp_path / "ours"), train_forms=2, val_forms=1, seed=7)
    jax_gen.main(root=str(tmp_path / "dhg"), train_forms=2, val_forms=1, seed=7)
    ours = sorted(p.relative_to(tmp_path / "ours") for p in (tmp_path / "ours").rglob("*")
                  if p.is_file())
    assert ours == sorted(p.relative_to(tmp_path / "dhg") for p in (tmp_path / "dhg").rglob("*")
                          if p.is_file())
    tifs = [p for p in ours if p.suffix == ".tif"]
    assert len(tifs) >= 9 and len(ours) == 2 * len(tifs) + 4  # + 3 ascii + splits.json
    for rel in ours:
        a, b = tmp_path / "ours" / rel, tmp_path / "dhg" / rel
        if rel.suffix == ".tif":
            img = images.read_tiff(a)
            assert img.shape == cv2.imread(str(b), cv2.IMREAD_GRAYSCALE).shape
            assert img.min() == 0 and img.max() == 255
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_style_extraction_refuses_the_cpu_by_default(iam_tree):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    root, splits = iam_tree
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        iam.extract_style_vectors([np.zeros((96, 64), np.float32)], style_weights=SYNTH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        iam.build_iam_cache(root, "train", splits, style_weights=SYNTH, **BUILD)
