"""Is a trained run's style pathway live? (port of
dhg/tools/eval_style_pathway.py)

    python -m dhg_torch.tools.eval_style_pathway --experiment_path=<run dir>
        [--tree=<IAM tree>] [--checkpoint=<path>] [--device=cpu]

1. Output swap: the run's model (float32, as dhg's load_model) samples one
   prompt with the style vectors of two line images of the tree
   (style_from_image with the run's dataset_args.style_weights) and with
   zero style, each call from a generator seeded 42 afresh, so the three
   share their noise; pairwise stroke MSE. A dead pathway gives ~0.
2. Conditional validation loss: eval.eval_batch over the run's validation
   cache (up to 256 rows) with each row's true style, zero style and the
   styles shuffled across rows (RandomState(0)), all three on ONE noise
   draw (a generator seeded 7, as dhg's one key). true < zero and true <
   shuffled means the model uses the style.

`tree` defaults to the run config's experiment.data_dir. Prints one JSON
dict with dhg's keys, plus `backend`.
"""

from __future__ import annotations

import glob
import json
import sys
from pathlib import Path

import numpy as np
import torch

from dhg_torch.tools.common import backend, tool_device

EPS_SEED = 7


def val_losses(model, cache, eps: torch.Tensor | None = None,
               device: str | torch.device = "cuda") -> dict[str, np.ndarray]:
    """eval_batch's [total, score, pen] with true, zero and shuffled style
    over the cache's first min(256, len) rows, all on the same `eps` (default
    a normal draw from a generator seeded 7, shaped like the rows' deltas)."""
    from dhg_torch.eval import eval_batch, eval_levels

    dev = torch.device(device)
    n = min(256, len(cache))
    strokes = torch.as_tensor(np.asarray(cache.strokes[:n], np.float32), device=dev)
    text = torch.as_tensor(np.asarray(cache.text[:n], np.int64), device=dev)
    style_true = torch.as_tensor(np.asarray(cache.style[:n], np.float32), device=dev)
    perm = torch.as_tensor(np.random.RandomState(0).permutation(n), device=dev)
    if eps is None:
        eps = torch.randn(strokes[..., :2].shape, generator=torch.Generator(dev).manual_seed(
            EPS_SEED), device=dev)
    levels = eval_levels().to(dev)
    return {name: eval_batch(model, strokes, text, sty, eps.to(dev), levels).cpu().numpy()
            for name, sty in [("true", style_true), ("zero", torch.zeros_like(style_true)),
                              ("shuffled", style_true[perm])]}


def conditional_val_loss(model, cache, eps: torch.Tensor | None = None,
                         device: str | torch.device = "cuda") -> dict:
    """val_losses rounded as dhg reports them, and whether the true style
    beats both zero and shuffled style on the total."""
    losses: dict = {name: [round(float(x), 5) for x in v]  # total, score, pen
                    for name, v in val_losses(model, cache, eps, device).items()}
    losses["style_informative"] = bool(
        losses["true"][0] < losses["zero"][0] and losses["true"][0] < losses["shuffled"][0])
    return losses


def run(experiment_path: str, tree: str | None = None, checkpoint: str | None = None,
        device: str | torch.device = "cuda") -> dict:
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a random trunk's warning is known here
        return _run(experiment_path, tree, checkpoint, torch.device(device))


def _run(experiment_path, tree, checkpoint, dev: torch.device) -> dict:
    from dhg_torch.checkpoint import resolve_checkpoint
    from dhg_torch.config import DLConfig
    from dhg_torch.inference import style_from_image
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools.eval_style_gap import _cos, _mse, output_swap
    from dhg_torch.train import load_cache

    exp = Path(experiment_path)
    ckpt = checkpoint if checkpoint else str(resolve_checkpoint(exp))
    model = DiffusionModel.load(ckpt, device=dev)
    cfg = DLConfig.load(str(exp / "config.yml"))
    weights = cfg.dataset_args.style_weights
    tree = tree or cfg.experiment.data_dir

    result: dict = {"checkpoint": ckpt, "backend": backend(dev)}

    # Probe 1: output response to a style swap (shared noise).
    tifs = sorted(glob.glob(str(Path(tree) / "lineImages" / "*" / "*" / "*.tif")))
    if len(tifs) >= 2:
        sa = style_from_image(tifs[0], style_weights=weights, device=dev)
        sb = style_from_image(tifs[len(tifs) // 2], style_weights=weights, device=dev)
        outs = output_swap(model, {"A": sa, "B": sb, "zero": torch.zeros_like(sa)}, dev)
        result["output_swap"] = {
            "mse_A_vs_B": _mse(outs["A"], outs["B"]),
            "mse_A_vs_zero": _mse(outs["A"], outs["zero"]),
            "output_mean_sq": float((outs["A"] ** 2).mean()),
            "style_cos_A_B": _cos(sa, sb),
        }

    # Probe 2: conditional val loss under true / zero / shuffled style.
    cache = load_cache(cfg, "validation", dev)
    if cache is not None and len(cache) >= 8:
        result["val_loss_by_style"] = conditional_val_loss(model, cache, device=dev)
    print(json.dumps(result))
    return result


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    if not kw.get("experiment_path"):
        raise SystemExit("usage: eval_style_pathway --experiment_path=<run dir> [--tree=...]")
    opt = {k: str(kw[k]) if kw.get(k) else None for k in ("tree", "checkpoint")}
    return run(str(kw["experiment_path"]), opt["tree"], opt["checkpoint"], device=dev)


if __name__ == "__main__":
    main()
