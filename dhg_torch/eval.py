"""Validation loss (port of the pass dhg/eval.py runs for the trainer's
val_freq boundaries).

The mean diffusion loss over a cache at a fixed grid of alpha_bar levels
(evenly spaced schedule indices, both extremes included), with one noise
draw per batch shared by every level, so numbers compare across steps and
runs. The model runs in eval mode (no dropout) and without gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from dhg_torch.core.losses import diffusion_loss
from dhg_torch.core.schedule import get_alpha_set


def eval_levels(n_levels: int = 6) -> torch.Tensor:
    """alpha_bar at n_levels evenly spaced schedule indices."""
    alpha_set = get_alpha_set()
    idx = np.linspace(0, alpha_set.shape[0] - 1, n_levels).astype(np.int64)
    return alpha_set[torch.from_numpy(idx)]


@torch.no_grad()
def eval_batch(model, strokes3, text, style, eps, levels) -> torch.Tensor:
    """[3] (total, score, pen) averaged over `levels` for one batch."""
    x, pen = strokes3[..., :2], strokes3[..., 2]
    rows = []
    for alpha in levels.tolist():
        alphas = torch.full((x.shape[0], 1), alpha, device=x.device)
        xt = alphas.sqrt()[..., None] * x + (1 - alphas).sqrt()[..., None] * eps
        eps_pred, pen_pred = model(xt, text, alphas.sqrt(), style)
        rows.append(torch.stack(diffusion_loss(eps, eps_pred, pen, pen_pred, alphas)))
    return torch.stack(rows).mean(0)


def evaluate(model, cache, batch_size: int = 16, seed: int = 0, n_levels: int = 6) -> np.ndarray:
    """Sample-weighted mean (total, score, pen) over a packed cache, on the
    model's device."""
    dev = next(model.parameters()).device
    levels = eval_levels(n_levels)
    was_training = model.training
    model.eval()
    totals, weights = [], []
    try:
        for i in range(0, len(cache), batch_size):
            sl = slice(i, min(i + batch_size, len(cache)))
            strokes3 = torch.as_tensor(cache.strokes[sl], dtype=torch.float32).to(dev)
            text = torch.as_tensor(np.asarray(cache.text[sl], np.int64)).to(dev)
            style = torch.as_tensor(cache.style[sl], dtype=torch.float32).to(dev)
            gen = torch.Generator(dev).manual_seed(seed * 1_000_003 + i)
            eps = torch.randn(strokes3[..., :2].shape, generator=gen, device=dev)
            totals.append(eval_batch(model, strokes3, text, style, eps, levels).cpu().numpy())
            weights.append(sl.stop - sl.start)
    finally:
        model.train(was_training)
    return np.average(np.stack(totals), axis=0, weights=weights)
