"""Generation-quality metrics (port of dhg/metrics.py).

1. rasterize_strokes: a numpy stroke rasteriser with show_strokes' pen
   semantics (dhg_torch.utils.vis.drawn_segments), a grey [H, W] page
   (white 255, ink 0);
2. stroke_stats / compare_stroke_sets: per-line statistics of (dx, dy, pen)
   sequences and two-sample Kolmogorov-Smirnov distances between a
   generated set and a reference set;
3. frechet_style_distance: a Frechet distance (the FID formula) over the
   frozen StyleExtractor's features of the rasterised lines, on the card.

    python -m dhg_torch.metrics --experiment_path=<run dir> [--split=validation]
        [--n_samples=64] [--batch_size=32] [--seed=0] [--n_steps=...]
        [--diffusion_mode=new] [--schedule=strided|halved] [--device=cpu]

samples lines for the split's real texts and styles and scores them against
the split's real strokes, printing one JSON dict. The model loads in float32
(as dhg's load_model); a distilled student (training_args.distilled_steps)
defaults to its own halved-grid DDIM sampler; explicit flags win.
"""

from __future__ import annotations

import numpy as np

from dhg_torch import resolve_device
from dhg_torch.utils.vis import drawn_segments, stamp_segments

# ---------------------------------------------------------------------------
# 1. Rasterizer
# ---------------------------------------------------------------------------


def rasterize_strokes(
    strokes: np.ndarray,
    height: int = 96,
    thickness: float = 1.2,
    pad: int = 4,
    max_width: int = 1400,
    width: int | None = None,
) -> np.ndarray:
    """Render a [T, 3] (dx, dy, pen) sequence to a grayscale [height, W] page.

    The ink geometry matches show_strokes (same drawn segments, y-up
    flipped to image rows); scale preserves aspect ratio with the glyph
    body fit to `height - 2*pad` rows. `width=None` sizes the page to the
    line (clipped to max_width); pass a fixed width for stackable batches
    (right-padded with white, like the dataset's pad_img).
    """
    xy, draw = drawn_segments(strokes)
    if not draw.any():
        return np.full((height, width or height), 255.0, np.float32)

    p0, p1 = xy[:-1][draw], xy[1:][draw]
    pts = np.concatenate([p0, p1], axis=0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    scale = (height - 2 * pad) / max(hi[1] - lo[1], 1e-6)
    natural = int(np.ceil((hi[0] - lo[0]) * scale)) + 2 * pad
    w = min(natural, max_width) if width is None else width
    if natural > w:  # fixed/clipped width: shrink to fit
        scale *= (w - 2 * pad) / max((hi[0] - lo[0]) * scale, 1e-6)

    to_px = lambda q: np.stack(
        [
            pad + (q[:, 0] - lo[0]) * scale,
            (height - 1 - pad) - (q[:, 1] - lo[1]) * scale,  # y-up -> row
        ],
        axis=1,
    )
    img = np.full((height, w), 255.0, np.float32)
    stamp_segments(img, to_px(p0), to_px(p1), thickness, 0.0)
    return img


# ---------------------------------------------------------------------------
# 2. Distributional stroke statistics
# ---------------------------------------------------------------------------


def _active_prefix(seq: np.ndarray) -> np.ndarray:
    """The sequence up to (and including) its last pen-up point.

    Both real cache rows (padded with (0, 0, 1) rows by pad_stroke_seq)
    and generated rows are compared over the same
    region show_strokes would render."""
    pen_up = np.flatnonzero(np.asarray(seq)[:, 2].round() == 1)
    if pen_up.size == 0:
        return np.asarray(seq)
    return np.asarray(seq)[: pen_up[-1] + 1]


def stroke_stats(strokes: np.ndarray | list) -> dict[str, np.ndarray]:
    """Per-line scalar statistics over a set of [T, 3] sequences.

    Returns {stat_name: [N] float array}. Stats are computed over each
    line's active prefix (up to the last pen-up point) so real padded rows
    and generated rows are comparable.
    """
    per_line: dict[str, list[float]] = {
        "dx_mean": [], "dx_std": [], "dy_mean": [], "dy_std": [],
        "pen_lift_rate": [], "mean_pen_run": [], "path_len": [],
        "active_len": [], "net_advance": [],
    }
    for seq in strokes:
        s = _active_prefix(seq)
        d = s[:, :2].astype(float)
        pen = s[:, 2].round()
        per_line["dx_mean"].append(d[:, 0].mean())
        per_line["dx_std"].append(d[:, 0].std())
        per_line["dy_mean"].append(d[:, 1].mean())
        per_line["dy_std"].append(d[:, 1].std())
        per_line["pen_lift_rate"].append(pen.mean())
        runs = np.diff(np.flatnonzero(np.concatenate([[1.0], pen])))
        per_line["mean_pen_run"].append(float(runs.mean()) if runs.size else 0.0)
        per_line["path_len"].append(float(np.hypot(d[:, 0], d[:, 1]).sum()))
        per_line["active_len"].append(float(len(s)))
        per_line["net_advance"].append(float(d[:, 0].sum()))
    return {k: np.asarray(v, float) for k, v in per_line.items()}


def ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic (sup |F_a - F_b|)."""
    a = np.sort(np.asarray(a, float).ravel())
    b = np.sort(np.asarray(b, float).ravel())
    if a.size == 0 or b.size == 0:
        return 1.0
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(fa - fb).max())


def compare_stroke_sets(generated, reference) -> dict:
    """Per-stat KS distances between two sets of stroke sequences.

    0 = identical distributions, 1 = disjoint. `ks_mean` summarizes."""
    ga, rb = stroke_stats(generated), stroke_stats(reference)
    ks = {k: round(ks_distance(ga[k], rb[k]), 4) for k in ga}
    ks["ks_mean"] = round(float(np.mean(list(ks.values()))), 4)
    return ks


# ---------------------------------------------------------------------------
# 3. Fréchet style distance
# ---------------------------------------------------------------------------


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray
) -> float:
    """Fréchet distance between two Gaussians (the FID formula).

    tr sqrt(cov1 @ cov2) is computed from the eigenvalues of the product
    (real and non-negative for PSD factors, up to roundoff — negatives are
    clipped), avoiding a scipy.linalg.sqrtm dependency.
    """
    diff = float(((mu1 - mu2) ** 2).sum())
    ev = np.linalg.eigvals(cov1 @ cov2)
    tr_sqrt = float(np.sqrt(np.clip(ev.real, 0.0, None)).sum())
    return diff + float(np.trace(cov1) + np.trace(cov2)) - 2.0 * tr_sqrt


def style_features(images: np.ndarray, feature_fn=None, batch_size: int = 32,
                   device: str = "cuda") -> np.ndarray:
    """[N, H, W] grey pages -> [N, 1280]: the frozen StyleExtractor's
    [14, 1280] output averaged over its 14 width bins. feature_fn None: the
    repo's default weights on `device` (a random trunk, quietly, where the
    file is missing)."""
    if feature_fn is None:
        feature_fn = style_feature_fn(device=device)
    feats = [
        np.asarray(feature_fn(images[i : i + batch_size]))
        for i in range(0, len(images), batch_size)
    ]
    return np.concatenate(feats, axis=0)


def style_feature_fn(style_weights=None, device: str = "cuda"):
    """The pages -> [B, 1280] embedding of style_features on `device`."""
    import warnings

    from dhg_torch.data.iam import style_apply

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init warning is known here
        apply = style_apply(style_weights, device)
    return lambda x: apply(x).mean(axis=1)


def frechet_style_distance(
    generated,
    reference,
    feature_fn=None,
    height: int = 96,
    width: int = 512,
    batch_size: int = 32,
    device: str = "cuda",
) -> float:
    """FID-style score between two sets of [T, 3] stroke sequences.

    Both sets are rasterized to fixed [height, width] pages, embedded with
    `style_features`, and compared with the Frechet (FID) formula. Lower
    is better; 0 means matching feature moments.
    """
    if feature_fn is None:
        feature_fn = style_feature_fn(device=device)
    pages = lambda seqs: np.stack(  # noqa: E731
        [rasterize_strokes(s, height=height, width=width) for s in seqs]
    )
    fg = style_features(pages(generated), feature_fn, batch_size)
    fr = style_features(pages(reference), feature_fn, batch_size)
    mu_g, mu_r = fg.mean(axis=0), fr.mean(axis=0)
    cov_g = np.cov(fg, rowvar=False).reshape(fg.shape[1], fg.shape[1])
    cov_r = np.cov(fr, rowvar=False).reshape(fr.shape[1], fr.shape[1])
    return frechet_distance(mu_g, cov_g, mu_r, cov_r)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def evaluate_generation(
    experiment_path: str,
    split: str = "validation",
    n_samples: int = 64,
    batch_size: int = 32,
    seed: int = 0,
    diffusion_mode: str | None = None,
    n_steps: int | None = None,
    schedule: str | None = None,
    use_ema: bool = True,
    fsd: bool = True,
    device: str = "cuda",
) -> dict:
    """Sample lines for a split's texts/styles and score them vs its strokes.

    Conditioning (text, style) comes from the split's real rows, so the
    comparison is generated-vs-real strokes for identical conditions. Batch
    i (the rows from i) samples from a torch.Generator seeded with
    seed * 1_000_003 + i on `device`.
    """
    from pathlib import Path

    import torch

    from dhg_torch.checkpoint import resolve_checkpoint
    from dhg_torch.config import DLConfig
    from dhg_torch.inference import generate
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.train import load_cache

    dev = resolve_device(device)
    exp = Path(experiment_path)
    model = DiffusionModel.load(resolve_checkpoint(exp), dtype=None, use_ema=use_ema, device=dev)
    cfg = DLConfig.load(str(exp / "config.yml"))
    # A distilled student is scored on the sampler it was trained for (its
    # own halved grid, deterministic DDIM), as infer does; flags win.
    distilled = cfg.training_args.distilled_steps
    if distilled:
        if n_steps is None:
            n_steps = int(distilled)
        if schedule is None:
            schedule = "halved"
        if diffusion_mode is None:
            diffusion_mode = "ddim"
    if diffusion_mode is None:
        diffusion_mode = "new"  # the reference default
    if schedule is None:
        schedule = "strided"
    cache = load_cache(cfg, split, dev)
    if cache is None or len(cache) == 0:
        raise RuntimeError(f"no samples in the {split!r} split")

    n = min(int(n_samples), len(cache))
    batch_size = int(batch_size)
    real = np.asarray(cache.strokes[:n])
    gen_rows = []
    for i in range(0, n, batch_size):
        sl = slice(i, min(i + batch_size, n))
        gen = torch.Generator(device=dev).manual_seed(int(seed) * 1_000_003 + i)
        out = generate(model, np.asarray(cache.text[sl], np.int64), cache.style[sl], gen,
                       seq_len=real.shape[1], diffusion_mode=diffusion_mode,
                       n_steps=n_steps, schedule=schedule, device=dev)
        gen_rows.append(out.cpu().numpy())
    gen = np.concatenate(gen_rows, axis=0)

    result: dict = {
        "split": split,
        "n": int(n),
        "sampler": {
            "diffusion_mode": diffusion_mode,
            "n_steps": n_steps or 60,
            "schedule": schedule,
        },
        "ks": compare_stroke_sets(gen, real),
    }
    if fsd:
        # Embed with the trunk the run trained against (its
        # dataset_args.style_weights), else the repo default.
        sw = cfg.dataset_args.style_weights
        feature_fn = style_feature_fn(sw, dev)
        if sw:
            result["fsd_trunk"] = str(sw)
        result["frechet_style_distance"] = round(
            frechet_style_distance(gen, real, feature_fn), 4
        )
        # Calibration: FSD between two halves of the real set, the noise
        # floor the generated score should be read against at this n.
        half = n // 2
        if half >= 2:
            result["fsd_real_vs_real"] = round(
                frechet_style_distance(real[:half], real[half : 2 * half], feature_fn), 4
            )
    return result


def main(argv=None) -> dict:
    """The CLI: --key=value arguments of evaluate_generation; prints JSON."""
    import json
    import sys

    from dhg_torch.config import parse_cli_kwargs

    kwargs = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    result = evaluate_generation(**kwargs)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
