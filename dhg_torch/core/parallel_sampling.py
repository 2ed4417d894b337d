"""Parallel-in-time DDIM sampling by Jacobi (Picard) iteration (port of
dhg/core/parallel_sampling.py).

Sequential DDIM defines states S_0 = x_T, S_{t+1} = F_t(S_t) with
    F_t(x) = ddim_step(x, eps(x, sigma_t), abar_t, abar_prev_t).
A Jacobi sweep updates every state from the previous iterate at once,
    S'_{t+1} = F_t(S_t)   for all t,
in ONE model call at batch n*B instead of n calls at batch B (Shih et al.
2023, "Parallel Sampling of Diffusion Models", the plain Jacobi variant
without a sliding window). After sweep k, S_t is exact for t <= k, so
`sweeps = n` reproduces the sequential trajectory; fewer sweeps trade
accuracy for wall time. DDIM only (eta = 0): the update is deterministic,
so the fixed point is well defined.

Cost model: a sweep is one batch-n*B forward; sequential batch-B sampling
is n forwards. Parallel wins when sweeps x step_cost(n*B) < n x
step_cost(B), i.e. when the card is underused at batch B.
tools/eval_parallel_sampler.py measures it.

The caller closes the conditioning over the model's full forward, tiled to
batch n*B, with one sigma per row (as dhg's eval tool does). The sampler
kernels' gate needs the batch-1 FiLM of the sampler's hoisted context, so
none of them runs on this path, in dhg or here.
"""

from __future__ import annotations

from typing import Callable

import torch

from dhg_torch import resolve_device
from dhg_torch.core.sampling import ddim_step
from dhg_torch.core.schedule import get_alpha_set, get_beta_set


def parallel_ddim_sample(
    denoise_fn: Callable,
    batch_size: int,
    seq_len: int,
    beta_set: torch.Tensor | None = None,
    sweeps: int | None = None,
    x_init: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    return_all_sweeps: bool = False,
    device: str | torch.device = "cuda",
):
    """Sample by Jacobi iteration over the whole reverse trajectory.

    denoise_fn(x [M, T, 2], sigma [M, 1]) -> (eps [M, T, 2], pen [M, T]) for
    M = n_steps * batch_size. x_T is `x_init` [B, T, 2], else drawn from
    `generator` as diffusion_sample draws it (its first draw), so the same
    generator gives comparable outputs. sweeps: Jacobi iterations, None =
    n_steps (exact). return_all_sweeps also returns every sweep's estimate
    [sweeps, B, T, 3] so convergence can be read from one run.

    Returns strokes [B, T, 3] float32 ((dx, dy) + the last step's pen), and
    the per-sweep estimates when return_all_sweeps. Runs under
    torch.inference_mode().
    """
    dev = resolve_device(device)
    f32 = torch.float32
    if beta_set is None:
        beta_set = get_beta_set()
    beta_set = beta_set.to(device=dev, dtype=f32)
    alpha_set = get_alpha_set(beta_set)
    n = beta_set.shape[0]
    if sweeps is None:
        sweeps = n
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    shape = (batch_size, seq_len, 2)
    with torch.inference_mode():
        if x_init is None:
            x_t = torch.randn(shape, generator=generator, device=dev, dtype=f32)
        else:
            x_t = x_init.to(device=dev, dtype=f32)
        # Reverse schedule order: step t uses index i = n-1-t; alpha_prev is
        # the DDIM rule's (1 at the last step).
        idxs = torch.arange(n - 1, -1, -1, device=dev)
        alphas = alpha_set[idxs]
        alpha_prevs = torch.where(idxs > 0, alpha_set[(idxs - 1).clamp(min=0)],
                                  torch.ones((), dtype=f32, device=dev))
        sig_rows = torch.sqrt(alphas)[:, None].repeat_interleave(batch_size, 0)  # [n*B, 1]
        a = alphas[:, None, None, None]
        a_prev = alpha_prevs[:, None, None, None]
        # S[t] is the state before step t, x_T everywhere to start; S[0] stays x_T.
        S = x_t[None].expand(n, *shape).clone()
        ests = []
        for _ in range(sweeps):
            eps, pen = denoise_fn(S.reshape(n * batch_size, seq_len, 2), sig_rows)
            eps = eps.reshape(n, *shape).to(f32)
            pen = pen.reshape(n, batch_size, seq_len).to(f32)
            x_next = ddim_step(S, eps, a, a_prev)  # x_next[t] = F_t(S[t])
            S = torch.cat([S[:1], x_next[:-1]], dim=0)
            # This sweep's estimate: the last step's post-state and its pen.
            ests.append(torch.cat([x_next[-1], pen[-1][..., None]], dim=-1))
        if return_all_sweeps:
            return ests[-1], torch.stack(ests)
        return ests[-1]
