"""Diffusion noise schedule (port of dhg/core/schedule.py), float32 tables.

"alpha" denotes alpha_bar = cumprod(1 - beta), as in dhg and the reference.

  * get_beta_set() == 0.02 + explin(1e-5, 0.4, 60)
  * get_alpha_set(beta) == cumprod(1 - beta)
  * strided_beta_set: n_steps kept levels, indices picked in float64 on the host
  * halve_beta_set / halved_beta_set: progressive-distillation 2-for-1 grids
  * sample_alphas: the training step's continuous alpha_bar draws
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_STEPS = 60
F32 = torch.float32


def explin(min_val: float, max_val: float, num: int) -> torch.Tensor:
    """Exponentially spaced values between min_val and max_val (log-linear)."""
    return torch.exp(torch.linspace(math.log(min_val), math.log(max_val), num, dtype=F32))


def get_beta_set(n_steps: int = N_STEPS) -> torch.Tensor:
    """The fixed 60-value beta schedule: 0.02 + explin(1e-5, 0.4, 60)."""
    return 0.02 + explin(1e-5, 0.4, n_steps)


def get_alpha_set(beta_set: torch.Tensor | None = None) -> torch.Tensor:
    """alpha_bar table: cumprod(1 - beta)."""
    if beta_set is None:
        beta_set = get_beta_set()
    return torch.cumprod(1.0 - beta_set, dim=0)


def strided_beta_set(n_steps: int, base: torch.Tensor | None = None) -> torch.Tensor:
    """n_steps alpha_bar levels of `base` (evenly spaced schedule indices,
    both endpoints kept), as the beta table whose cumprod reproduces them
    exactly: beta_j = 1 - abar[s_j] / abar[s_{j-1}] (abar[s_{-1}] = 1).
    n_steps == len(base) returns base unchanged."""
    if base is None:
        base = get_beta_set()
    n = base.shape[0]
    if not 2 <= n_steps <= n:
        raise ValueError(f"n_steps must be in [2, {n}], got {n_steps}")
    if n_steps == n:
        return base
    # float64 on the host: an f32 linspace flips some indices (59 of 60).
    idx = torch.from_numpy(np.linspace(0, n - 1, n_steps).round().astype(np.int64))
    abar = get_alpha_set(base)[idx.to(base.device)]
    prev = torch.cat([torch.ones(1, dtype=abar.dtype, device=abar.device), abar[:-1]])
    return 1.0 - abar / prev


def halve_beta_set(base: torch.Tensor) -> torch.Tensor:
    """One 2-for-1 halving of the level array [1, abar_0, ..., abar_{N-1}]."""
    n = base.shape[0]
    if n % 2 != 0:
        raise ValueError(f"halving needs an even step count, got {n}")
    abar = get_alpha_set(base)
    levels = torch.cat([torch.ones(1, dtype=abar.dtype, device=abar.device), abar])[::2]
    return 1.0 - levels[1:] / levels[:-1]


def halved_beta_set(n_steps: int, base: torch.Tensor | None = None) -> torch.Tensor:
    """`base` (default: the canonical 60) halved repeatedly down to n_steps."""
    beta = get_beta_set() if base is None else base
    start = beta.shape[0]
    while beta.shape[0] > n_steps:
        if beta.shape[0] % 2 != 0:
            raise ValueError(
                f"{n_steps} steps is not reachable by halving from {start} "
                f"(stuck at odd {beta.shape[0]})"
            )
        beta = halve_beta_set(beta)
    if beta.shape[0] != n_steps:
        raise ValueError(f"halving overshot: wanted {n_steps}, hit {beta.shape[0]}")
    return beta


def alphas_from_draws(idx: torch.Tensor, u: torch.Tensor, alpha_set: torch.Tensor) -> torch.Tensor:
    """alpha_bar between alpha_set[idx] and alpha_set[idx + 1] at fraction u:
    the arithmetic of dhg's sample_alphas on pre-drawn idx, u ([B, 1])."""
    lower = alpha_set[idx]
    upper = alpha_set[idx + 1]
    return u * (upper - lower) + lower


def sample_alphas(generator: torch.Generator, batch_size: int, alpha_set: torch.Tensor
                  ) -> torch.Tensor:
    """[B, 1] alpha_bar values: a random adjacent pair of levels per sample,
    then uniform between them. Draws from `generator` (on alpha_set's device)."""
    dev = alpha_set.device
    idx = torch.randint(0, alpha_set.shape[0] - 1, (batch_size, 1), generator=generator, device=dev)
    u = torch.rand((batch_size, 1), generator=generator, device=dev)
    return alphas_from_draws(idx, u, alpha_set)
