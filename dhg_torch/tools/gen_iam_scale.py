"""Generate an IAM-shaped tree at the real split size (port of
dhg/tools/gen_iam_scale.py), to drive the cache build without IAM files.

The layout is the one the build scans:

    <root>/ascii/<a01>/<a01-000>/<form>.txt         CSR: transcription
    <root>/lineStrokes/<a01>/<a01-000>/<form>-<nn>.xml
    <root>/lineImages/<a01>/<a01-000>/<form>-<nn>.tif
    <root>/splits.json

Content is synthetic but meets each drop filter at a realistic rate: a few %
of lines have text >= max_text_len, strokes too long after the 3 combine
passes, or an image >= img_width wide after the crop and resize. Per-form
"writer" parameters (slant, step, amplitude, frequency, pen width) vary, and
each line image is drawn from the line's own strokes, so a style image
carries its writer's stroke statistics. Raw point counts (500-900 a line)
are in the real IAM range.

The text and the XML come from dhg's RandomState draws in dhg's order, so at
one seed they are byte for byte dhg's. The images have dhg's shapes but are
drawn by dhg_torch.utils.vis.stamp_segments (a round pen, no anti-aliasing)
where dhg uses cv2.polylines(LINE_AA), and written by
dhg_torch.data.images.write_tiff (uncompressed) where dhg's cv2.imwrite
writes LZW: their pixels differ.

    python -m dhg_torch.tools.gen_iam_scale --root=<dir> [--train_forms=1534]
        [--val_forms=192] [--lines_per_form=7] [--seed=7]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from dhg_torch.data.images import write_tiff
from dhg_torch.utils.vis import stamp_segments

WORDS = (
    "the quick brown fox jumps over a lazy dog and then runs far away "
    "while some other animals watch from near trees with great interest "
    "writing lines of text by hand takes time but looks rather nice "
    "every form has several sentences that differ in length and style"
).split()


def _line_text(rng: np.random.RandomState, force_long: bool = False) -> str:
    words = [WORDS[rng.randint(len(WORDS))] for _ in range(rng.randint(4, 11))]
    s = " ".join(words)
    if force_long:
        while len(s) < 50:  # trips the len(text) >= max_text_len drop filter
            s += " " + WORDS[rng.randint(len(WORDS))]
        return s
    return s[:49]


def _stroke_xml(
    rng: np.random.RandomState,
    n_points: int,
    slant: float,
    step: float,
    amp: float,
    freq: float = 35.0,
) -> tuple[str, list[np.ndarray]]:
    """One line's XML and its stroke point arrays: a rightward-drifting
    jittered walk split into strokes (IAM coordinates are absolute pen
    positions in the thousands). The points are returned so the line image
    is drawn from the same trajectory: as in real IAM, the style image then
    carries the writer's stroke statistics (slant, amplitude, frequency)."""
    n_strokes = max(3, n_points // rng.randint(40, 90))
    sizes = np.full(n_strokes, n_points // n_strokes)
    sizes[: n_points - sizes.sum()] += 1
    x = 100.0 + rng.rand() * 500
    base_y = 200.0 + rng.rand() * 800
    parts = ["<WhiteboardCaptureSession><StrokeSet>"]
    stroke_pts: list[np.ndarray] = []
    for sz in sizes:
        t = np.arange(int(sz))
        dx = step + rng.randn(int(sz)) * 2.0
        xs = x + np.cumsum(dx)
        # freq is a per-writer trait (with a small per-stroke jitter): unlike
        # amp and step it survives the parser's per-line std normalization,
        # so it carries the writer into normalized stroke space.
        ys = base_y + amp * np.sin(xs / (freq * (0.9 + 0.2 * rng.rand()))) + slant * (xs - x)
        ys += rng.randn(int(sz)) * 1.5
        x = xs[-1] + step * rng.randint(2, 6)
        xi, yi = xs.astype(np.int64), ys.astype(np.int64)
        pts = "".join(
            f'<Point x="{px}" y="{py}" time="{tt}"/>'
            for px, py, tt in zip(xi, yi, t)
        )
        parts.append("<Stroke>" + pts + "</Stroke>")
        stroke_pts.append(np.stack([xi, yi], 1).astype(np.float64))
    parts.append("</StrokeSet></WhiteboardCaptureSession>")
    return "".join(parts), stroke_pts


def _line_image(
    stroke_pts: list[np.ndarray],
    pen_px: int,
    height: int = 140,
    force_wide: bool = False,
) -> np.ndarray:
    """The line's own strokes drawn into a [height, width] grey image (dark
    ink on white, a per-form pen width), dhg's geometry: the ink scaled to
    ~65 px tall; a line whose aspect would exceed the img_width filter after
    the resize is compressed horizontally to stay under it, except a
    force_wide one, left wide to meet that filter."""
    all_pts = np.concatenate(stroke_pts)
    lo, hi = all_pts.min(0), all_pts.max(0)
    ink_h = max(hi[1] - lo[1], 1.0)
    scale_y = 65.0 / ink_h
    sx = scale_y
    w = (hi[0] - lo[0]) * sx
    if w > 840 and not force_wide:
        sx *= 840.0 / w
    width = int((hi[0] - lo[0]) * sx) + 16
    img = np.full((height, width), 255, np.uint8)
    y0 = (height - 65) / 2.0
    for pts in stroke_pts:
        px = ((pts[:, 0] - lo[0]) * sx + 8).astype(np.int32)
        py = ((pts[:, 1] - lo[1]) * scale_y + y0).astype(np.int32)
        pen = np.stack([px, py], 1).astype(np.float64)
        stamp_segments(img, pen[:-1], pen[1:], pen_px / 2)
    return img


def main(
    root: str,
    train_forms: int = 1534,
    val_forms: int = 192,
    lines_per_form: int = 7,
    seed: int = 7,
):
    t0 = time.time()
    root_p = Path(root)
    rng = np.random.RandomState(seed)
    prefixes = [f"{c}{i:02d}" for c in "abcdefghjklmnp" for i in range(16)]

    splits: dict[str, list[str]] = {"train": [], "validation": []}
    n_lines = 0
    counters: dict[str, int] = {}
    for kind, n_forms in (("train", train_forms), ("validation", val_forms)):
        for _ in range(n_forms):
            pre = prefixes[rng.randint(len(prefixes))]
            idx = counters.get(pre, 0)
            counters[pre] = idx + 1
            form = f"{pre}-{idx:03d}{'uxz'[rng.randint(3)] if rng.rand() < 0.3 else ''}"
            splits[kind].append(form)
            d1, d2 = form[:3], form[:7]
            for sub in ("ascii", "lineStrokes", "lineImages"):
                (root_p / sub / d1 / d2).mkdir(parents=True, exist_ok=True)

            # Per-form "writer" bundle: slant/step/amplitude.
            slant = rng.randn() * 0.06
            step = 6.0 + rng.rand() * 6.0
            amp = 15.0 + rng.rand() * 25.0
            freq = 18.0 + rng.rand() * 50.0  # per-writer oscillation period
            pen_px = rng.randint(1, 4)  # per-form pen thickness (image only)

            k = max(3, lines_per_form + rng.randint(-2, 3))
            texts = []
            for i in range(1, k + 1):
                sid = f"{form}-{i:02d}"
                # ~3% overlong text, ~2% overlong strokes, ~2% overwide image:
                # each exercises one reference drop filter at realistic rates.
                long_text = rng.rand() < 0.03
                texts.append(_line_text(rng, force_long=long_text))
                n_pts = rng.randint(500, 900)
                if rng.rand() < 0.02:
                    n_pts = rng.randint(1300, 1800)  # survives 3x combine > 480
                xml, stroke_pts = _stroke_xml(rng, n_pts, slant, step, amp, freq)
                (root_p / "lineStrokes" / d1 / d2 / f"{sid}.xml").write_text(xml)
                # The image is drawn from the same strokes; ~2% keep their
                # natural (wide) aspect to meet the >= img_width filter after
                # read_img's crop and resize to 96 rows.
                write_tiff(
                    root_p / "lineImages" / d1 / d2 / f"{sid}.tif",
                    _line_image(stroke_pts, pen_px, force_wide=rng.rand() < 0.02),
                )
                n_lines += 1
            (root_p / "ascii" / d1 / d2 / f"{form}.txt").write_text(
                "OCR:\n\nx\n\nCSR:\n\n" + "\n".join(texts) + "\n"
            )

    (root_p / "splits.json").write_text(json.dumps(splits))
    du = sum(f.stat().st_size for f in root_p.rglob("*") if f.is_file())
    summary = {
        "root": str(root_p),
        "train_forms": len(splits["train"]),
        "val_forms": len(splits["validation"]),
        "lines": n_lines,
        "disk_mb": round(du / 1e6, 1),
        "gen_s": round(time.time() - t0, 1),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    kw = {}
    for arg in sys.argv[1:]:
        if arg.startswith("--") and "=" in arg:
            k, v = arg[2:].split("=", 1)
            kw[k] = v if k == "root" else int(v)
    main(**kw)
