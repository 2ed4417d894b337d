"""How well the StyleExtractor's vectors tell writers apart, and whether a
trained model listens to them (port of dhg/tools/eval_style_gap.py).

    python -m dhg_torch.tools.eval_style_gap [--experiment_path=<run dir>] [--device=cpu]

1. Writer discrimination (no model needed): synthetic "writers", each a
   fixed bundle of handwriting parameters (slant, pen thickness, x-height,
   spacing, jitter, loopiness), render 6 lines each; the trunk's [14 x 1280]
   vectors are scored by cosine top-1 same-writer retrieval (self
   excluded; chance (K-1)/(N K-1)) and the intra/inter cosine-distance
   ratio, beside a raw-pixel baseline (the 8x-downsampled image). The
   trunk is the repo default's, data/mobilenetv2_tv.npz: absent, so random
   (flax's init from `seed`, as dhg).
2. Style ablation (with --experiment_path): the run's model samples one
   prompt with writer A's, writer B's and zero style, each call from a
   generator seeded 42 afresh, so the three share their noise; pairwise
   stroke MSE. A-vs-B and A-vs-zero far above 0 mean the pathway is live.

Prints dhg's report lines (`  key: value`), and `backend`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dhg_torch.tools.common import backend, tool_device

STYLE_H = 96  # the dataset's line-image height (dhg_torch/data/images.py)
# The benchmark main and train_style_trunk.evaluate score: writers, lines a
# writer, width (dhg's; the tests set them small).
BENCHMARK_WRITERS, BENCHMARK_LINES, BENCHMARK_WIDTH = 8, 6, 384


# --------------------------------------------------------------------------
# Synthetic "writers": a parametric pseudo-handwriting renderer
# --------------------------------------------------------------------------


def _writer_params(writer_id: int) -> dict:
    """Deterministic per-writer style bundle."""
    rng = np.random.default_rng(1000 + writer_id)
    return {
        "slant": float(rng.uniform(-0.45, 0.45)),  # shear dx/dy
        "thickness": float(rng.uniform(0.8, 3.2)),  # pen radius px
        "x_height": float(rng.uniform(14.0, 34.0)),  # glyph body height px
        "spacing": float(rng.uniform(8.0, 22.0)),  # advance per glyph px
        "jitter": float(rng.uniform(0.02, 0.35)),  # curvature noise
        "loopiness": float(rng.uniform(0.5, 2.0)),  # arc amplitude scale
    }


def _stamp_polyline(img64: np.ndarray, px: np.ndarray, py: np.ndarray, r: float) -> None:
    """dhg's disk stamping of one glyph, all stamps at once: each segment
    sampled at np.linspace(0, 1, max(int(2 |segment|), 1) + 1), stamps whose
    centre lies off the page skipped, each pixel within `r` of a stamp
    taken to min(pixel, 255 - 255 clip((r^2 - d^2) / r^2, 0, 1)). The
    float64 arithmetic is dhg's, term for term; dhg casts to float32 after
    each stamp, which commutes with the minimum, so img64 holds the
    float64 minimum and the caller casts once."""
    height, width = img64.shape
    x0, y0, x1, y1 = px[:-1], py[:-1], px[1:], py[1:]
    segs = [max(int(np.hypot(a1 - a0, b1 - b0) * 2), 1)
            for a0, b0, a1, b1 in zip(x0, y0, x1, y1)]
    s = np.concatenate([np.linspace(0, 1, n + 1) for n in segs])
    idx = np.repeat(np.arange(len(segs)), np.asarray(segs) + 1)
    cx = x0[idx] + s * (x1[idx] - x0[idx])
    cy = y0[idx] + s * (y1[idx] - y0[idx])
    on = (0 <= cx) & (cx < width) & (0 <= cy) & (cy < height)
    cx, cy = cx[on], cy[on]
    if not len(cx):
        return
    # Every pixel with d^2 < r^2 lies inside dhg's window [c - r - 1, c + r + 2);
    # a pixel outside it gets ink 0, which leaves the minimum alone.
    reach = int(np.ceil(r)) + 1
    off = np.arange(-reach, reach + 1)
    cols = np.floor(cx).astype(np.int64)[:, None, None] + off[None, None, :]
    rows = np.floor(cy).astype(np.int64)[:, None, None] + off[None, :, None]
    d2 = (cols - cx[:, None, None]) ** 2 + (rows - cy[:, None, None]) ** 2
    ink = np.clip((r**2 - d2) / max(r**2, 1e-6), 0, 1) * 255.0
    keep = (ink > 0) & (cols >= 0) & (cols < width) & (rows >= 0) & (rows < height)
    flat = (np.broadcast_to(rows, ink.shape) * width + np.broadcast_to(cols, ink.shape))[keep]
    np.minimum.at(img64.reshape(-1), flat, 255.0 - ink[keep])


def render_line(writer_id: int, text_seed: int, width: int = 384) -> np.ndarray:
    """One [STYLE_H, width] float32 pseudo-handwriting line, dhg's pixels.

    Each "glyph" is 2-4 joined arcs whose shape comes from the text_seed
    stream and whose rendering (slant, thickness, size, spacing, jitter)
    from the writer bundle. White page (255), dark ink (~0)."""
    p = _writer_params(writer_id)
    rng = np.random.default_rng(50_000 + text_seed)
    img = np.full((STYLE_H, width), 255.0, np.float64)

    baseline = STYLE_H * 0.62
    x_pen = 12.0
    while x_pen < width - 24:
        n_arcs = int(rng.integers(2, 5))
        t = np.linspace(0, 1, 24)
        pts = []
        cx, cy = 0.0, 0.0
        for _ in range(n_arcs):
            amp = rng.uniform(0.3, 1.0) * p["loopiness"]
            phase = rng.uniform(0, 2 * np.pi)
            dx = rng.uniform(0.2, 0.7)
            x_arc = cx + t * dx
            y_arc = cy + amp * np.sin(2 * np.pi * t * rng.uniform(0.5, 1.5) + phase) * 0.5
            pts.append(np.stack([x_arc, y_arc], 1))
            cx, cy = x_arc[-1], y_arc[-1]
        curve = np.concatenate(pts, 0)  # [T, 2] in glyph units
        gx = curve[:, 0] * p["x_height"]
        gy = curve[:, 1] * p["x_height"]
        gy += rng.normal(0, p["jitter"] * p["x_height"], gy.shape)
        gx = gx + p["slant"] * gy
        _stamp_polyline(img, x_pen + gx, baseline - gy, p["thickness"])
        x_pen += p["spacing"] + p["x_height"] * 0.4
    return img.astype(np.float32)


def benchmark_lines(n_writers: int = 8, per_writer: int = 6, width: int = 384):
    """([N K, H, W] float32 lines, [N K] writer labels) of the benchmark:
    writer w's k-th line from text seed w * 131 + k."""
    imgs, labels = [], []
    for w in range(n_writers):
        for k in range(per_writer):
            imgs.append(render_line(w, text_seed=w * 131 + k, width=width))
            labels.append(w)
    return np.stack(imgs), np.asarray(labels)


# --------------------------------------------------------------------------
# Experiment 1: writer discrimination
# --------------------------------------------------------------------------


def _retrieval_metrics(vecs: np.ndarray, labels: np.ndarray) -> dict:
    """Cosine top-1 same-writer retrieval + intra/inter distance stats."""
    v = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    sim = v @ v.T
    dist = 1.0 - sim
    np.fill_diagonal(sim, -np.inf)

    nn_idx = sim.argmax(axis=1)
    top1 = float((labels[nn_idx] == labels).mean())

    same = labels[:, None] == labels[None, :]
    off = ~np.eye(len(labels), dtype=bool)
    intra = float(dist[same & off].mean())
    inter = float(dist[~same].mean())
    return {
        "top1_retrieval": round(top1, 4),
        "intra_cos_dist": round(intra, 4),
        "inter_cos_dist": round(inter, 4),
        "intra_over_inter": round(intra / max(inter, 1e-9), 4),
    }


def style_vectors(extractor, imgs: np.ndarray, batch: int = 32) -> np.ndarray:
    """[N, H, W] grey lines -> [N, 14 x 1280] float32 through `extractor`'s
    apply_fn (style_extractor.make_apply_fn: on CUDA a batch shape's calls
    after its first replay a captured graph)."""
    from dhg_torch.models.style_extractor import make_apply_fn

    dev = next(extractor.parameters()).device
    apply_fn, out = make_apply_fn(extractor), []
    for lo in range(0, len(imgs), batch):
        x = torch.from_numpy(np.ascontiguousarray(imgs[lo:lo + batch], np.float32)).to(dev)
        out.append(apply_fn(x).reshape(x.shape[0], -1).cpu().numpy())
    return np.concatenate(out)


def quiet_extractor(weights=None, seed: int = 0, device="cuda"):
    """init_style_extractor without its random-init warning (intended here)."""
    import warnings

    from dhg_torch.models.style_extractor import init_style_extractor

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return init_style_extractor(weights, seed=seed, device=device)


def writer_discrimination(n_writers: int = 8, per_writer: int = 6, width: int = 384,
                          seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Top-1 same-writer retrieval and the intra/inter distance ratio of the
    default trunk's vectors, beside the raw-pixel baseline."""
    dev = torch.device(device)
    batch, labels = benchmark_lines(n_writers, per_writer, width)
    vecs = style_vectors(quiet_extractor(seed=seed, device=dev), batch)

    chance = (per_writer - 1) / (len(labels) - 1)
    result = {
        "n_writers": n_writers,
        "per_writer": per_writer,
        "chance": round(chance, 4),
        **_retrieval_metrics(vecs, labels),
    }
    pix = batch[:, ::8, ::8].reshape(len(labels), -1) - batch.mean()
    result["pixel_baseline"] = _retrieval_metrics(pix, labels)
    result["backend"] = backend(dev)
    return result


# --------------------------------------------------------------------------
# Experiment 2: style-ablation response of a trained model
# --------------------------------------------------------------------------


def output_swap(model, styles: dict, device: torch.device, seed: int = 42) -> dict:
    """Sample "style ablation probe" (50 tokens, seq_len 200) once per style
    in `styles`, each call from a generator seeded `seed` afresh, so all
    share x_T and every step's noise (dhg passes one key to every call)."""
    from dhg_torch.data.tokenizer import Tokenizer
    from dhg_torch.inference import generate

    text = torch.as_tensor(np.asarray(Tokenizer().encode_batch(["style ablation probe"], 50),
                                      np.int64), device=device)
    return {
        name: generate(model, text, s, torch.Generator(device).manual_seed(seed), seq_len=200,
                       device=device).cpu().numpy()
        for name, s in styles.items()
    }


def _mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(((a - b) ** 2).mean())


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm()))


def style_ablation(experiment_path: str, width: int = 384,
                   device: str | torch.device = "cuda") -> dict:
    """Pairwise output MSE for writer-A / writer-B / zero style, shared noise."""
    from dhg_torch.tools.common import load_model

    from dhg_torch.models.style_extractor import make_apply_fn

    dev = torch.device(device)
    apply_fn = make_apply_fn(quiet_extractor(device=dev))
    model = load_model({"experiment_path": experiment_path}, dev)

    def style_of(img):
        return apply_fn(torch.from_numpy(img[None]).to(dev))

    style_a, style_b = style_of(render_line(0, 7, width)), style_of(render_line(5, 7, width))
    outs = output_swap(model, {"A": style_a, "B": style_b, "zero": torch.zeros_like(style_a)},
                       dev)
    return {
        "mse_A_vs_B": _mse(outs["A"], outs["B"]),
        "mse_A_vs_zero": _mse(outs["A"], outs["zero"]),
        "mse_B_vs_zero": _mse(outs["B"], outs["zero"]),
        "output_mean_sq": float((outs["A"] ** 2).mean()),
        "style_vec_cos_A_B": _cos(style_a, style_b),
        "backend": backend(dev),
    }


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    report = {}
    print("== writer discrimination (random-init trunk) ==")
    report["discrimination"] = writer_discrimination(BENCHMARK_WRITERS, BENCHMARK_LINES,
                                                     BENCHMARK_WIDTH, device=dev)
    for k_, v_ in report["discrimination"].items():
        print(f"  {k_}: {v_}")
    if kw.get("experiment_path"):
        print("== style-ablation response ==")
        report["ablation"] = style_ablation(str(kw["experiment_path"]), BENCHMARK_WIDTH,
                                            device=dev)
        for k_, v_ in report["ablation"].items():
            print(f"  {k_}: {v_}")
    return report


if __name__ == "__main__":
    main()
