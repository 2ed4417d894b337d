"""The IAM-OnDB cache build (port of dhg/data/iam.py).

One offline pass over the IAM tree makes a packed cache of fixed-shape
arrays (dhg_torch.data.pipeline.IAMCache):

  strokes  f32[N, max_seq_len, 3]
  text     i32[N, max_text_len]
  style    f32[N, 14, 1280]

Training then gathers random batches from it on the device. The build is
dhg's, line for line:
  * text filter: len(text) >= max_text_len drops the line;
  * stroke filter: longer than max_seq_len after the 3 combine passes, or
    any |coordinate| > 15, drops it (pad_stroke_seq -> None);
  * image filter: a line whose cropped, resized image is >= img_width wide
    is dropped;
  * style source: a random other line of the same form, drawn from a
    per-form RandomState((seed + crc32(form)) % 2**32), so the cache is one
    function of the tree and the arguments, whatever the worker count;
  * style vectors from the frozen StyleExtractor on `device`, in batches of
    32 at the common width; wider images resized (cubic) to the nearest
    multiple of 128 and batched by width.
The file name (iam_cache_<fingerprint>.npz), the fingerprint and the npz
keys are dhg's, so a cache built by either package loads in the other.

Where this differs from dhg: images are read by dhg_torch.data.images (PNG
or TIFF, no cv2; within one grey level of cv2's resize), and each line image
is read once per form even where it is also another line's style source.
A `stats` dict, when given, gets the line counts by filter and the seconds
by stage.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from pathlib import Path

import numpy as np

from dhg_torch.data.images import pad_img, read_img, resize_cubic_float
from dhg_torch.data.pipeline import IAMCache
from dhg_torch.data.strokes import pad_stroke_seq, parse_lines_txt, parse_strokes_xml
from dhg_torch.data.tokenizer import Tokenizer

logger = logging.getLogger(__name__)

# Build arguments that do not change the cache, so not in its fingerprint.
NOT_FINGERPRINTED = ("style_apply_fn", "workers", "device", "stats")


def _build_form(
    form: str,
    data_dir: Path,
    img_height: int,
    img_width: int,
    max_text_len: int,
    max_seq_len: int,
    seed: int,
    tokenizer: Tokenizer,
) -> tuple[list[tuple[str, np.ndarray, np.ndarray, np.ndarray]], collections.Counter]:
    """One form: its lines parsed and filtered, each with its style image.

    Returns ([(sample_id, strokes, text_ids, style_img), ...], counts), where
    counts holds the lines dropped by each filter and the CPU seconds of
    this thread spent parsing strokes and reading images."""
    counts: collections.Counter = collections.Counter()
    strokes_dir = data_dir / "lineStrokes" / form[:3] / form[:7]
    img_dir = data_dir / "lineImages" / form[:3] / form[:7]
    ascii_path = data_dir / "ascii" / form[:3] / form[:7] / f"{form}.txt"
    if not ascii_path.exists():
        counts["forms_missing"] += 1
        return [], counts

    text_dict = parse_lines_txt(ascii_path)
    form_valid = []
    for sid, text in text_dict.items():
        if len(text) >= max_text_len:
            counts["dropped_text"] += 1
        elif (strokes_dir / f"{sid}.xml").exists() and (img_dir / f"{sid}.tif").exists():
            form_valid.append(sid)
        else:
            counts["dropped_missing"] += 1
    rng = np.random.RandomState((seed + zlib.crc32(form.encode())) % (2**32))
    images: dict[str, np.ndarray] = {}

    def image(sid: str) -> np.ndarray:
        if sid not in images:
            t0 = time.thread_time()
            images[sid] = read_img(img_dir / f"{sid}.tif", img_height)
            counts["image_s"] += time.thread_time() - t0
            counts["images_read"] += 1
        return images[sid]

    out = []
    for sid in form_valid:
        t0 = time.thread_time()
        strokes = pad_stroke_seq(parse_strokes_xml(strokes_dir / f"{sid}.xml"),
                                 maxlength=max_seq_len)
        counts["parse_s"] += time.thread_time() - t0
        if strokes is None:
            counts["dropped_strokes"] += 1
            continue
        if image(sid).shape[1] >= img_width:
            counts["dropped_image"] += 1
            continue

        style_source = sid
        if len(form_valid) > 1:
            candidates = [s for s in form_valid if s != sid]
            style_source = candidates[rng.randint(len(candidates))]
        style_img = image(style_source)
        if style_img.shape[1] < img_width:
            style_img = pad_img(style_img, img_width, img_height)
        else:
            # Kept at its natural width (the extractor's adaptive pooling
            # takes any width); extract_style_vectors buckets such widths.
            style_img = style_img.astype("float32")
        out.append((sid, strokes, tokenizer.encode_padded(text_dict[sid], max_text_len),
                    style_img))
    return out, counts


def build_iam_cache(
    data_dir: str | Path,
    kind: str = "train",
    splits_file: str | Path = "data/splits.json",
    img_height: int = 96,
    img_width: int = 1400,
    max_text_len: int = 50,
    max_seq_len: int = 480,
    max_files: int | None = None,
    seed: int = 54321,
    style_apply_fn=None,
    style_batch: int = 32,
    style_weights: str | Path | None = None,
    style_width_bucket: int = 128,
    workers: int | None = None,
    device: str = "cuda",
    stats: dict | None = None,
) -> IAMCache:
    """Scan the IAM tree for split `kind` and build its packed cache.

    style_apply_fn: [B, H, W] float32 images -> [B, 14, 1280] (numpy); None
    builds the frozen StyleExtractor on `device` from `style_weights` (None
    resolves to <repo>/data/mobilenetv2_tv.npz; a missing file warns loudly
    and leaves the trunk random). workers: forms on a thread pool (None =
    min(8, cpus); 1 = serial); the cache is the same for every count."""
    t_start = time.perf_counter()
    data_dir = Path(data_dir)
    tokenizer = Tokenizer()
    if workers is None:
        workers = min(8, os.cpu_count() or 1)

    with open(splits_file) as f:
        splits = json.load(f)

    strokes_all: list[np.ndarray] = []
    text_all: list[np.ndarray] = []
    style_imgs: list[np.ndarray] = []
    sample_ids: list[str] = []
    counts: collections.Counter = collections.Counter()

    def worker(form: str):
        return _build_form(form, data_dir, img_height, img_width, max_text_len, max_seq_len,
                           seed, tokenizer)

    def consume(result) -> bool:
        """Append one form's samples in order; True when max_files is hit."""
        form_results, form_counts = result
        counts.update(form_counts)
        for sid, strokes, text_ids, style_img in form_results:
            strokes_all.append(strokes)
            text_all.append(text_ids)
            style_imgs.append(style_img)
            sample_ids.append(sid)
            if max_files and len(sample_ids) >= max_files:
                return True
        return False

    forms = list(splits[kind])
    if workers <= 1:
        for form in forms:
            if consume(worker(form)):
                break
    else:
        # Chunks in split order, so a small max_files build does not fan out
        # over the whole split.
        it = iter(forms)
        done = False
        with ThreadPoolExecutor(max_workers=workers) as ex:
            while not done:
                chunk = list(islice(it, workers * 4))
                if not chunk:
                    break
                for result in ex.map(worker, chunk):
                    if consume(result):
                        done = True
                        break
    t_forms = time.perf_counter()

    if not sample_ids:
        raise RuntimeError(f"no valid IAM samples found under {data_dir}")

    logger.info("IAM %s: %d samples; extracting style vectors...", kind, len(sample_ids))
    style = extract_style_vectors(style_imgs, style_apply_fn, style_batch, style_weights,
                                  width_bucket=style_width_bucket, device=device)
    t_style = time.perf_counter()
    if stats is not None:
        stats.update(counts)
        stats.update(forms=len(forms), kept=len(sample_ids), workers=workers,
                     forms_s=t_forms - t_start, style_s=t_style - t_forms,
                     build_s=t_style - t_start,
                     style_wide=sum(int(img.shape[1] > img_width) for img in style_imgs))
    return IAMCache(
        strokes=np.stack(strokes_all).astype(np.float32),
        text=np.stack(text_all).astype(np.int32),
        style=style,
        sample_ids=sample_ids,
    )


def style_apply(style_weights=None, device: str = "cuda"):
    """The frozen StyleExtractor on `device` as a numpy function [B, H, W]
    -> [B, 14, 1280] float32, through its apply_fn (style_extractor.
    make_apply_fn: on CUDA a shape's calls after its first replay a captured
    graph)."""
    import torch

    from dhg_torch.models.style_extractor import init_style_extractor, make_apply_fn

    model = init_style_extractor(style_weights, device=device)
    dev = next(model.parameters()).device
    apply_fn = make_apply_fn(model)

    def apply(imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32)).to(dev)
        return apply_fn(x).cpu().numpy()

    return apply


def extract_style_vectors(
    style_imgs,
    style_apply_fn=None,
    batch: int = 32,
    style_weights=None,
    width_bucket: int = 128,
    device: str = "cuda",
) -> np.ndarray:
    """The style vectors [N, 14, 1280] of `style_imgs`.

    Images at the most common width run in batches of `batch`. Wider ones
    are resized (cubic, as cv2.resize on float32) to the nearest multiple of
    `width_bucket` and batched by that width; width_bucket=0 runs each at
    its own width instead. style_apply_fn None: the StyleExtractor on
    `device` (style_apply)."""
    if style_apply_fn is None:
        style_apply_fn = style_apply(style_weights, device)

    shapes = {img.shape for img in style_imgs}
    if not shapes:
        return np.zeros((0, 14, 1280), np.float32)
    common = max(shapes, key=lambda s: sum(1 for i in style_imgs if i.shape == s))
    out = [None] * len(style_imgs)

    def run_batched(idx_list, imgs):
        # Stacked a batch at a time: the images of a real split take GBs.
        for lo in range(0, len(idx_list), batch):
            chunk = idx_list[lo : lo + batch]
            vecs = np.asarray(style_apply_fn(np.stack([imgs[i] for i in chunk])
                                             .astype(np.float32)))
            for j, idx in enumerate(chunk):
                out[idx] = vecs[j]

    batched_idx = [i for i, img in enumerate(style_imgs) if img.shape == common]
    if batched_idx:
        run_batched(batched_idx, style_imgs)

    rest = [i for i, img in enumerate(style_imgs) if out[i] is None]
    if rest and width_bucket:
        groups: dict[tuple[int, int], list[int]] = {}
        resized: dict[int, np.ndarray] = {}
        for i in rest:
            img = style_imgs[i]
            h, w = img.shape
            wb = max(width_bucket, int(round(w / width_bucket)) * width_bucket)
            resized[i] = resize_cubic_float(img.astype(np.float32), wb, h)
            groups.setdefault((h, wb), []).append(i)
        for _, idxs in sorted(groups.items()):
            run_batched(idxs, resized)
    else:
        for i in rest:
            out[i] = np.asarray(style_apply_fn(style_imgs[i].astype(np.float32)[None]))[0]
    return np.stack(out).astype(np.float32)


def cache_fingerprint(**kwargs) -> str:
    """Stable fingerprint of dataset-build arguments for cache file naming."""
    blob = json.dumps({k: str(v) for k, v in sorted(kwargs.items())})
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def cache_path(cache_dir: str | Path, **build_kwargs) -> Path:
    """Where load_or_build_cache keeps the cache of `build_kwargs`: dhg's
    name, salted by its builder version (2: the per-form style-source RNG)."""
    fp = cache_fingerprint(
        _builder=2, **{k: v for k, v in build_kwargs.items() if k not in NOT_FINGERPRINTED})
    return Path(cache_dir) / f"iam_cache_{fp}.npz"


class IAMDataset:
    """Map-style view over the packed cache, for inspection and eval loops
    (training gathers its batches on the device instead)."""

    def __init__(self, cache: IAMCache | None = None, **build_kwargs):
        self.cache = cache if cache is not None else build_iam_cache(**build_kwargs)

    def __len__(self) -> int:
        return len(self.cache)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        return {
            "strokes": self.cache.strokes[idx],
            "text": self.cache.text[idx],
            "style": self.cache.style[idx],
        }

    @property
    def dataset(self) -> "IAMDataset":
        return self


def load_or_build_cache(cache_dir: str | Path, **build_kwargs) -> IAMCache:
    """Load the packed cache if present, else build and save it."""
    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    path = cache_path(cache_dir, **build_kwargs)
    stats = build_kwargs.get("stats")
    if path.exists():
        logger.info("loading packed IAM cache %s", path)
        if stats is not None:
            stats.update(loaded=str(path))
        return IAMCache.load(path)
    cache = build_iam_cache(**build_kwargs)
    t0 = time.perf_counter()
    cache.save(path)
    if stats is not None:
        stats.update(built=str(path), save_s=time.perf_counter() - t0,
                     npz_bytes=path.stat().st_size)
    logger.info("saved packed IAM cache %s (%d samples)", path, len(cache))
    return cache
