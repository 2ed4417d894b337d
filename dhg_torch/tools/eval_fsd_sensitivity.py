"""Sensitivity of the Fréchet style distance (port of
dhg/tools/eval_fsd_sensitivity.py).

    python -m dhg_torch.tools.eval_fsd_sensitivity --cache=<packed .npz>
        [--weights=data/style_trunk_synth.npz] [--n=48] [--seed=0] [--device=cpu]

A held-out set of real stroke rows is corrupted at increasing strength c
and scored by FSD against a disjoint real reference set; the metric should
rise monotonically in c, for the random-init trunk (a missing weights path,
flax's init from seed 0) and for the trained one (--weights, else
data/style_trunk_synth.npz where it exists). Corruption at level c:
Gaussian noise of std c on the (dx, dy) deltas of active rows (padding
stays padding) and pen bits flipped with probability c / 5. The level-0
score (two disjoint real sets) is the noise floor; `feature_std` is the
trunk's feature spread over 16 of the rasterised probe lines.

Prints one JSON dict {trunk: {...}} with dhg's keys, plus `backend`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from dhg_torch.tools.common import backend, tool_device

LEVELS = (0.0, 0.1, 0.25, 0.5, 1.0)
RANDOM_TRUNK = "/nonexistent/force_random.npz"  # dhg's way to force the random init
DEFAULT_TRAINED = Path(__file__).resolve().parents[2] / "data" / "style_trunk_synth.npz"


def corrupt(rows: np.ndarray, c: float, seed: int = 0) -> np.ndarray:
    """Noise the deltas and flip pen bits of [N, T, 3] rows at strength c."""
    rng = np.random.RandomState(int(seed + c * 1000))
    out = rows.copy()
    active = ~((rows[..., 0] == 0) & (rows[..., 1] == 0) & (rows[..., 2] == 1))
    noise = rng.randn(*rows.shape[:2], 2).astype(np.float32) * c
    out[..., :2] += noise * active[..., None]
    flips = (rng.rand(*rows.shape[:2]) < c / 5.0) & active
    out[..., 2] = np.where(flips, 1.0 - np.round(out[..., 2]), out[..., 2])
    return out


def feature_fn_for(weights: str | None, device: str | torch.device = "cuda"):
    """The pages -> [B, 1280] embedding of the trunk in `weights` on `device`."""
    from dhg_torch.metrics import style_feature_fn

    return style_feature_fn(weights, device)


def run(cache_path: str, weights: str | None = None, n: int = 48, seed: int = 0,
        device: str | torch.device = "cuda") -> dict:
    from dhg_torch.data.pipeline import IAMCache
    from dhg_torch.metrics import frechet_style_distance, rasterize_strokes, style_features

    dev = torch.device(device)
    cache = IAMCache.load(cache_path)
    rows = np.asarray(cache.strokes)
    if len(rows) < 2 * n:
        raise ValueError(f"need >= {2 * n} rows, cache has {len(rows)}")
    reference, probe = rows[:n], rows[n: 2 * n]

    trunks: dict[str, str | None] = {"random_init": RANDOM_TRUNK}
    tw = weights if weights is not None else (
        str(DEFAULT_TRAINED) if DEFAULT_TRAINED.exists() else None)
    if tw:
        trunks["trained"] = tw

    result: dict = {"n": n, "levels": list(LEVELS), "backend": backend(dev)}
    for name, w in trunks.items():
        fn = feature_fn_for(w, dev)
        scores = {}
        for c in LEVELS:
            scores[str(c)] = round(
                float(frechet_style_distance(corrupt(probe, c, seed), reference, fn)), 6)
        vals = [scores[str(c)] for c in LEVELS]
        # A trunk whose embeddings barely vary across real lines cannot
        # separate corruption levels either.
        pages = np.stack([rasterize_strokes(s_, width=512) for s_ in probe[:16]])
        fvar = float(style_features(pages, fn).std(axis=0).mean())
        # The level-0 score IS the sampling noise floor (two disjoint real
        # sets); corruption below it is indistinguishable by construction.
        floor = max(vals[0], vals[1], 1e-9)
        above = vals[2:]
        result[name] = {
            "fsd": scores,
            "noise_floor": round(floor, 6),
            "monotone_above_floor": bool(
                all(a < b for a, b in zip(above, above[1:])) and above[0] > floor),
            "range_vs_floor": round(vals[-1] / floor, 1),
            "feature_std": round(fvar, 6),
        }
    print(json.dumps(result))
    return result


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    if "cache" not in kw:
        raise SystemExit("usage: eval_fsd_sensitivity --cache=<packed .npz> [--weights=...] "
                         "[--n=48]")
    weights = str(kw["weights"]) if kw.get("weights") else None
    return run(str(kw["cache"]), weights, n=int(kw.get("n", 48)), seed=int(kw.get("seed", 0)),
               device=dev)


if __name__ == "__main__":
    main()
