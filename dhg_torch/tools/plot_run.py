"""Plot training curves from a run dir, metrics.jsonl or run.log (port of
dhg/tools/plot_run.py).

    python -m dhg_torch.tools.plot_run --experiment_path <run dir> [--output out.png]
    python -m dhg_torch.tools.plot_run --log <run.log or metrics.jsonl>

The parsers are dhg's: the reference's log line (`Step N | Loss: ... |
Score: ... | Pen: ...`), dhg's validation line, and metrics.jsonl, which
both packages' trainers write. The figure keeps dhg's curves: train
total (solid), score (dashed) and pen (dotted), and validation loss as
points joined by a line, on a log-scale y axis, in matplotlib's first
four default colours, inside a frame with a light grid line at every
decade. The card's machine has no matplotlib, so the curves are drawn by
the port's own rasteriser (utils/vis.py::stamp_segments, a round pen, no
anti-aliasing) and written by data/images.py::write_png: the pixels are
not matplotlib's, and there is no text (no tick labels, axis labels or
legend). Everything runs on the host; there is no device work, so the
tool takes no --device.
"""

from __future__ import annotations

import argparse
import json
import math
import re
from pathlib import Path

import numpy as np

# The shared log-line contract (the reference's train line; dhg and the
# port write the same). Val lines are dhg's.
_TRAIN_RE = re.compile(
    r"Step (\d+) \| Loss: ([\d.eE+-]+) \| Score: ([\d.eE+-]+) \| Pen: ([\d.eE+-]+)"
)
_VAL_RE = re.compile(
    r"Step (\d+) \| Val Loss: ([\d.eE+-]+) \| Val Score: ([\d.eE+-]+) \| Val Pen: ([\d.eE+-]+)"
)

SIZE = (1080, 600)  # dhg's figsize (9, 5) at dpi 120
AXES_BOX = (0.125, 0.11, 0.9, 0.88)  # matplotlib's subplot box: left, bottom, right, top
COLOURS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40))  # C0-C3
DASHES = {"-": None, "--": (11.0, 5.0), ":": (2.0, 3.5)}  # on/off lengths in pixels


def parse_log(text: str) -> dict[str, list]:
    """Extract train/val loss rows from run.log text (either framework)."""
    hist: dict[str, list] = {"train": [], "val": []}
    for line in text.splitlines():
        m = _TRAIN_RE.search(line)
        if m:
            step, loss, score, pen = m.groups()
            hist["train"].append(
                {"step": int(step), "loss": float(loss), "score": float(score), "pen": float(pen)}
            )
            continue
        m = _VAL_RE.search(line)
        if m:
            step, loss, score, pen = m.groups()
            hist["val"].append({"step": int(step), "val_loss": float(loss),
                                "val_score": float(score), "val_pen": float(pen)})
    return hist


def parse_jsonl(text: str) -> dict[str, list]:
    """Extract train/val rows from a metrics.jsonl."""
    hist: dict[str, list] = {"train": [], "val": []}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        hist["val" if "val_loss" in rec else "train"].append(rec)
    return hist


def load_history(experiment_path: str | Path | None = None, log: str | Path | None = None):
    """History from a run dir (metrics.jsonl preferred, run.log fallback)
    or an explicit log/jsonl file path."""
    if log is not None:
        p = Path(log)
        text = p.read_text()
        return parse_jsonl(text) if p.suffix == ".jsonl" else parse_log(text)
    run = Path(experiment_path or ".")
    if (run / "metrics.jsonl").exists():
        return parse_jsonl((run / "metrics.jsonl").read_text())
    if (run / "run.log").exists():
        return parse_log((run / "run.log").read_text())
    raise FileNotFoundError(f"no metrics.jsonl or run.log under {run}")


def _limits(lo: float, hi: float) -> tuple[float, float]:
    """matplotlib's 5% data margins (a flat range widened by one unit)."""
    if hi == lo:
        return lo - 1.0, hi + 1.0
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


def _draw(img, points: np.ndarray, colour, dashes, radius: float, dots: bool = False) -> None:
    """A polyline through `points` [N, 2] (column, row), solid or dashed, or
    one dot at each point."""
    from dhg_torch.utils.vis import stamp_segments

    if dots:
        a = b = points
    elif dashes is None:
        a, b = points[:-1], points[1:]
    else:
        # Cut the polyline at every on/off boundary along its length.
        seg = np.diff(points, axis=0)
        length = np.hypot(*seg.T)
        at = np.concatenate([[0.0], np.cumsum(length)])
        on, off = dashes
        starts = np.arange(0.0, at[-1], on + off)
        ends = np.minimum(starts + on, at[-1])

        def point(s):
            i = np.clip(np.searchsorted(at, s, side="right") - 1, 0, len(seg) - 1)
            frac = (s - at[i]) / np.maximum(length[i], 1e-12)
            return points[i] + frac[:, None] * seg[i]

        a, b = point(starts), point(ends)
    for ch, value in enumerate(colour):
        stamp_segments(img[..., ch], a, b, radius, value)


def plot_history(hist: dict[str, list], output: str | Path) -> Path:
    """Render the curves to a PNG; returns the written path."""
    from dhg_torch.data.images import write_png

    if not hist["train"] and not hist["val"]:
        raise ValueError("history contains no loss rows")
    curves = []  # (steps, values, colour, dashes, markers)
    if hist["train"]:
        steps = [r["step"] for r in hist["train"]]
        for i, (key, style) in enumerate((("loss", "-"), ("score", "--"), ("pen", ":"))):
            curves.append((steps, [r[key] for r in hist["train"]], COLOURS[i], DASHES[style],
                           False))
    if hist["val"]:
        curves.append(([r["step"] for r in hist["val"]], [r["val_loss"] for r in hist["val"]],
                       COLOURS[3], None, True))
    # A log axis shows positive values only (matplotlib masks the rest).
    curves = [(np.asarray(s, float)[np.asarray(v) > 0], np.log10(np.asarray(v)[np.asarray(v) > 0]),
               c, d, m) for s, v, c, d, m in curves]
    xs = np.concatenate([c[0] for c in curves])
    ys = np.concatenate([c[1] for c in curves])
    if xs.size == 0:
        raise ValueError("history contains no positive loss values for a log axis")
    (xlo, xhi), (ylo, yhi) = _limits(xs.min(), xs.max()), _limits(ys.min(), ys.max())
    w, h = SIZE
    left, bottom, right, top = AXES_BOX
    c0, c1 = left * w, right * w
    r0, r1 = (1 - top) * h, (1 - bottom) * h

    def to_pixel(x, y):
        return np.stack([c0 + (c1 - c0) * (np.asarray(x) - xlo) / (xhi - xlo),
                         r1 - (r1 - r0) * (np.asarray(y) - ylo) / (yhi - ylo)], axis=1)

    img = np.full((h, w, 3), 255, np.uint8)
    for decade in range(math.ceil(ylo), math.floor(yhi) + 1):  # the grid, alpha 0.3 on white
        row = to_pixel([xlo], [decade])[0, 1]
        _draw(img, np.array([[c0, row], [c1, row]]), (222, 222, 222), None, 0.5)
    frame = np.array([[c0, r0], [c1, r0], [c1, r1], [c0, r1], [c0, r0]])
    _draw(img, frame, (0, 0, 0), None, 0.5)
    for steps, logs, colour, dashes, markers in curves:
        if steps.size == 0:
            continue
        pts = to_pixel(steps, logs)
        _draw(img, pts, colour, dashes, 1.5 * 120 / 72 / 2)  # 1.5 pt lines at 120 dpi
        if markers:  # "o", ms=4
            _draw(img, pts, colour, None, 4 * 120 / 72 / 2, dots=True)
    out = Path(output)
    write_png(out, img)
    return out


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiment_path", help="run dir with metrics.jsonl or run.log")
    ap.add_argument("--log", help="explicit run.log / metrics.jsonl file path")
    ap.add_argument("--output", default=None, help="output PNG (default: <run>/loss_curves.png)")
    args = ap.parse_args(argv)
    if not args.experiment_path and not args.log:
        ap.error("one of --experiment_path / --log is required")

    hist = load_history(args.experiment_path, args.log)
    base = Path(args.experiment_path) if args.experiment_path else Path(args.log).parent
    out = plot_history(hist, args.output or base / "loss_curves.png")
    n_t, n_v = len(hist["train"]), len(hist["val"])
    print(f"wrote {out} ({n_t} train rows, {n_v} val rows)")
    return out


if __name__ == "__main__":
    main()
