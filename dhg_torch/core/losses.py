"""Training losses (port of dhg/core/losses.py): score MSE + alpha_bar-weighted
pen-lift BCE.

  score_loss = mean over (B, T) of sum over xy of (eps - eps_hat)^2
  pen_loss   = mean over B of [mean over T of BCE(p_hat, clip(p)) * alpha_bar]

Only the target is clamped, to [1e-7, 1 - 1e-7]. torch's own
F.binary_cross_entropy is the semantics dhg reproduces by hand: its logs are
clamped at -100 and its backward is (p - t) / max(p (1 - p), 1e-12).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def score_loss_fn(eps: torch.Tensor, eps_pred: torch.Tensor) -> torch.Tensor:
    """mean(sum((eps - eps_pred)^2, axis=-1))."""
    return ((eps - eps_pred) ** 2).sum(dim=-1).mean()


def pen_loss_fn(pen: torch.Tensor, pen_pred: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """pen, pen_pred [B, T] (targets, probabilities); alphas [B, 1]."""
    bce = F.binary_cross_entropy(pen_pred, pen.clamp(1e-7, 1.0 - 1e-7), reduction="none")
    return (bce.mean(dim=1) * alphas.squeeze(-1)).mean()


def diffusion_loss(eps, eps_pred, pen, pen_pred, alphas):
    """(total, score_loss, pen_loss)."""
    s = score_loss_fn(eps, eps_pred)
    p = pen_loss_fn(pen, pen_pred, alphas)
    return s + p, s, p
