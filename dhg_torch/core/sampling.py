"""Reverse-diffusion step rules and the sampler loop (port of
dhg/core/sampling.py).

  * standard_diffusion_step — DDPM ancestral step
        x_{t-1} = (1/sqrt(1-beta)) * (x - beta * eps / sqrt(1-abar)) [+ sqrt(beta) z, i > 0]
  * new_diffusion_step — the paper's rule
        x_{t-1} = (x - sqrt(1-abar) * eps) / sqrt(1-beta) + sqrt(1 - abar_next) z
    with abar_next = alpha_set[i-1] for i > 1 else 1 (the reference's quirk:
    i == 1 counts as the clean end too)
  * ddim_step — deterministic DDIM (eta = 0) with abar_prev = alpha_set[i-1]
    for i > 0 else 1

dhg runs the loop as one lax.scan; here it is a Python loop over the
reversed schedule. The model is called with sigma = sqrt(abar_i); the last
step's pen-lift probabilities become channel 3 of the result.
diffusion_sample_encoder_reuse runs the same loop with the U-Net's encoder
half cached between steps; core/parallel_sampling.py iterates the whole
DDIM trajectory at once.
"""

from __future__ import annotations

from typing import Callable

import torch

from dhg_torch.core.schedule import get_alpha_set, get_beta_set


def standard_diffusion_step(xt, eps_pred, beta, alpha, noise, add_sigma: bool):
    """DDPM ancestral step; `noise` is N(0,1), added only when add_sigma."""
    x_prev = (1.0 / torch.sqrt(1.0 - beta)) * (xt - beta * eps_pred / torch.sqrt(1.0 - alpha))
    return x_prev + torch.sqrt(beta) * noise if add_sigma else x_prev


def new_diffusion_step(xt, eps_pred, beta, alpha, alpha_next, noise):
    """The paper's alternative step rule."""
    x_prev = (xt - torch.sqrt(1.0 - alpha) * eps_pred) / torch.sqrt(1.0 - beta)
    return x_prev + noise * torch.sqrt(1.0 - alpha_next)


def ddim_step(xt, eps_pred, alpha, alpha_prev):
    """Deterministic DDIM update (eta = 0)."""
    x0_hat = (xt - torch.sqrt(1.0 - alpha) * eps_pred) / torch.sqrt(alpha)
    return torch.sqrt(alpha_prev) * x0_hat + torch.sqrt(1.0 - alpha_prev) * eps_pred


def infer_seq_len(num_tokens: int) -> int:
    """16 per token, then T - T % 8 + 8: always rounds UP past a multiple of 8
    (adds 8 even when already divisible), as the reference does."""
    t = 16 * num_tokens
    return t - (t % 8) + 8


def per_sample_noise_streams(seeds, n_steps: int, seq_len: int,
                             device: str | torch.device = "cuda"
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Independent noise streams, one per batch row: (x_init [B, T, 2],
    noises [n_steps, B, T, 2]), float32 on `device`.

    Row r comes only from seeds[r] (with seq_len and n_steps): its own CPU
    torch.Generator draws x_T, then the n steps' noise in one draw. So a
    request's noise is the same whether it is sampled alone or co-batched,
    and the same on the CPU as on the card (a Philox stream on the card
    would give a seed other strokes there than in the CPU tests). The draws
    run on the host; the result is then copied to the device."""
    xs, zs = [], []
    for seed in seeds:
        gen = torch.Generator().manual_seed(int(seed))
        xs.append(torch.randn((seq_len, 2), generator=gen))
        zs.append(torch.randn((n_steps, seq_len, 2), generator=gen))
    return torch.stack(xs).to(device), torch.stack(zs, dim=1).to(device)


def diffusion_sample(
    denoise_fn: Callable,
    batch_size: int,
    seq_len: int,
    beta_set: torch.Tensor | None = None,
    mode: str = "new",
    generator: torch.Generator | None = None,
    x_init: torch.Tensor | None = None,
    noises: torch.Tensor | None = None,
    temperature: float = 1.0,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Run the reverse-diffusion loop; returns strokes [B, T, 3] (float32).

    denoise_fn(x [B,T,2], sigma [B,1], t) -> (eps [B,T,2], pen [B,T]) is
    called for loop steps t = 0..n-1, i.e. schedule index i = n-1-t.

    Randomness comes either from `generator` (x_T first, then one draw per
    step) or from pre-drawn `x_init` [B,T,2] and `noises` [n,B,T,2] in loop
    order — the tests hand in the exact draws dhg's jax.random makes.
    Temperature scales x_T and every injected noise.
    """
    device = torch.device(device)
    f32 = torch.float32
    if beta_set is None:
        beta_set = get_beta_set()
    beta_set = beta_set.to(device=device, dtype=f32)
    alpha_set = get_alpha_set(beta_set)
    n = beta_set.shape[0]
    shape = (batch_size, seq_len, 2)
    if (x_init is None) != (noises is None):
        raise ValueError("pass both x_init and noises, or neither")
    if x_init is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=f32)
    else:
        x = x_init.to(device=device, dtype=f32)
    if temperature != 1.0:
        x = x * temperature
    one = torch.ones((), dtype=f32, device=device)
    pen = None
    for t in range(n):
        i = n - 1 - t
        alpha, beta = alpha_set[i], beta_set[i]
        sigma = torch.sqrt(alpha) * torch.ones((batch_size, 1), dtype=f32, device=device)
        eps_pred, pen = denoise_fn(x, sigma, t)
        if mode == "ddim":
            alpha_prev = alpha_set[i - 1] if i > 0 else one
            x = ddim_step(x, eps_pred, alpha, alpha_prev)
            continue
        if noises is None:
            noise = torch.randn(shape, generator=generator, device=device, dtype=f32)
        else:
            noise = noises[t].to(device=device, dtype=f32)
        if temperature != 1.0:
            noise = noise * temperature
        if mode == "standard":
            x = standard_diffusion_step(x, eps_pred, beta, alpha, noise, i > 0)
        else:
            alpha_next = alpha_set[i - 1] if i > 1 else one
            x = new_diffusion_step(x, eps_pred, beta, alpha, alpha_next, noise)
    return torch.cat([x, pen[..., None].to(f32)], dim=-1)


def diffusion_sample_encoder_reuse(
    encode_fn: Callable,
    decode_fn: Callable,
    batch_size: int,
    seq_len: int,
    beta_set: torch.Tensor | None = None,
    mode: str = "new",
    reuse_every: int = 1,
    generator: torch.Generator | None = None,
    x_init: torch.Tensor | None = None,
    noises: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The sampler with U-Net encoder-feature caching (experimental speed
    mode; Li et al., "Faster Diffusion", arXiv:2312.09608).

    encode_fn(x, t) -> (h1, h2, h3) runs only on loop steps t (0..n-1, not
    the schedule index) with t % reuse_every == 0; decode_fn(feats, t) ->
    (eps, pen) runs every step on the newest cached skip features against
    step t's conditioning. reuse_every=1 is the exact sampler. The step
    rules, the draws (`generator`, or `x_init` / `noises` as in
    diffusion_sample) and the last step's pen are diffusion_sample's; there
    is no temperature, as in dhg's. DHG_FUSED_T4=1 does not apply: dhg
    fuses the T/4..T/8 region inside `denoise` only, and the two halves run
    enc4/enc5 and the bottleneck unfused by it, there and here.

    QUALITY WARNING (dhg's measurement on trained weights): reuse_every=2
    drifts to 3x the 1e-3 stroke-MSE parity bar, and reuse_every >= 3
    diverges numerically (MSE > 1e6). No recommended setting exists; this
    stays an experimental research knob.
    """
    if reuse_every < 1:
        raise ValueError(f"reuse_every must be >= 1, got {reuse_every}")
    feats = None

    def denoise(x, sigma, t):
        nonlocal feats
        if t % reuse_every == 0:
            feats = encode_fn(x, t)
        return decode_fn(feats, t)

    return diffusion_sample(denoise, batch_size, seq_len, beta_set, mode=mode,
                            generator=generator, x_init=x_init, noises=noises, device=device)
