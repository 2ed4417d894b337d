"""Validation loss (port of dhg/eval.py): the pass the trainer runs at its
val_freq boundaries, and the standalone CLI over a saved checkpoint.

    python -m dhg_torch.eval --experiment_path=<run dir> [--split=validation]
        [--batch_size=16] [--seed=0] [--use_ema=True] [--n_levels=6]
        [--device=cpu]

The mean diffusion loss over a cache at a fixed grid of alpha_bar levels
(evenly spaced schedule indices, both extremes included), with one noise
draw per batch shared by every level, so numbers compare across steps and
runs. The mean is weighted by samples: the tail batch runs at its natural
size. The model runs in eval mode (no dropout) and without gradients. The
CLI prints one line, `Val Loss: ... | Val Score: ... | Val Pen: ...`, as
the train log's validation line.
"""

from __future__ import annotations

import numpy as np
import torch

from dhg_torch import resolve_device
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


def evaluate_checkpoint(
    experiment_path: str | None = None,
    config_path: str | None = None,
    checkpoint_path: str | None = None,
    split: str = "validation",
    batch_size: int = 16,
    seed: int = 0,
    use_ema: bool = True,
    n_levels: int = 6,
    device: str = "cuda",
) -> np.ndarray:
    """(total, score, pen) of a saved checkpoint on a data split.

    experiment_path supplies config.yml and the newest checkpoint
    (model_final, model_last, then the highest checkpoint_<N>); explicit
    paths win. The model loads in float32 (as dhg's load_model) with its EMA
    weights where it has them and use_ema."""
    from dhg_torch.checkpoint import resolve_run_paths
    from dhg_torch.config import DLConfig
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.train import load_cache

    config_path, checkpoint_path = resolve_run_paths(experiment_path, config_path,
                                                     checkpoint_path)
    dev = resolve_device(device)
    model = DiffusionModel.load(checkpoint_path, dtype=None, use_ema=use_ema, device=dev)
    cfg = DLConfig.load(config_path)
    cache = load_cache(cfg, split, dev)
    if cache is None or len(cache) == 0:
        raise RuntimeError(f"no samples in the {split!r} split")
    return evaluate(model, cache, batch_size=min(int(batch_size), len(cache)), seed=int(seed),
                    n_levels=int(n_levels))


def main(argv=None) -> np.ndarray:
    """The CLI: --key=value arguments of evaluate_checkpoint."""
    import sys

    from dhg_torch.config import parse_cli_kwargs

    kwargs = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    total, score, pen = out = evaluate_checkpoint(**kwargs)
    print(f"Val Loss: {total:.3f} | Val Score: {score:.3f} | Val Pen: {pen:.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
