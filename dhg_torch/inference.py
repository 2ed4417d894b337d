"""The line sampler (port of dhg/inference.py::generate / sample_lines).

It follows dhg's default "compact" hoist (_sample_jit):
  * sigma embeddings and every FiLM coefficient are computed at batch 1 for
    all noise levels before the loop;
  * the text-style encoder's `pre` runs once and its `tail` once per level,
    before the loop;
  * each step rebuilds the cross-attention K/V from its level's memory and
    runs the U-Net; the x carry and the heads are float32;
  * guidance runs a second U-Net pass against the null text, which keeps
    token 0 open (all-padding text would mask every key).
The loop runs under torch.inference_mode().
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from dhg_torch import resolve_device
from dhg_torch.core.sampling import diffusion_sample, infer_seq_len
from dhg_torch.core.schedule import N_STEPS, get_alpha_set, get_beta_set
from dhg_torch.data.tokenizer import Tokenizer
from dhg_torch.ops.basic import create_padding_mask


@lru_cache(maxsize=None)
def _device_beta_set(n_steps: int, schedule: str, device: str) -> torch.Tensor:
    """The coarsened beta table for (n_steps, schedule), built once per device.
    Callers must not modify it."""
    from dhg_torch.core.schedule import halved_beta_set, strided_beta_set

    if schedule == "halved":
        table = halved_beta_set(n_steps)
    elif schedule == "strided":
        table = strided_beta_set(n_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return table.to(device)


def _check_model_device(model, device: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != device.type or (
        device.index is not None and p.device.index != device.index
    ):
        raise ValueError(f"model is on {p.device}, sampling was asked on {device}")


def generate(
    model,
    text,  # [B, L] token ids
    style,  # [B, 14, 1280]
    generator: torch.Generator | None = None,
    seq_len: int | None = None,
    diffusion_mode: str = "new",
    guidance_scale: float | None = None,
    n_steps: int | None = None,
    schedule: str = "strided",
    temperature: float | None = None,
    x_init: torch.Tensor | None = None,
    noises: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Sample stroke sequences [B, seq_len, 3] (float32) for tokenized prompts.

    diffusion_mode: "new" (the reference default) | "standard" (DDPM) |
    "ddim"; any other string runs "new", as in the reference.
    guidance_scale: eps = eps_null + g (eps_text - eps_null); None or 1 skips
    the null branch. n_steps / schedule: a "strided" or "halved" sub-schedule
    of the canonical 60 levels. temperature scales x_T and all injected
    noise. Randomness comes from `generator` (on `device`) or from pre-drawn
    `x_init` [B,T,2] and `noises` [n,B,T,2] (see diffusion_sample).
    """
    dev = resolve_device(device)
    _check_model_device(model, dev)
    if guidance_scale is not None and float(guidance_scale) == 1.0:
        guidance_scale = None
    temperature = 1.0 if temperature is None else float(temperature)
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if n_steps is not None and n_steps != N_STEPS:
        beta_set = _device_beta_set(int(n_steps), schedule, str(dev))
    else:
        beta_set = get_beta_set().to(dev)
    if not isinstance(text, torch.Tensor):
        text = np.asarray(text)
    text = torch.as_tensor(text, dtype=torch.long, device=dev)
    style = torch.as_tensor(style, dtype=torch.float32, device=dev)
    if seq_len is None:
        seq_len = infer_seq_len(int((text != 0).sum(dim=1).max()))
    if seq_len % 8 != 0:
        raise ValueError(f"seq_len must be a multiple of 8, got {seq_len}")

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        return _sample(model, text, style, generator, seq_len, beta_set, diffusion_mode,
                       guidance_scale, temperature, x_init, noises, dev)


def _sample(model, text, style, generator, seq_len, beta_set, mode, guidance_scale,
            temperature, x_init, noises, dev):
    alpha_set = get_alpha_set(beta_set)
    n = beta_set.shape[0]
    # Reverse schedule order: loop step t uses schedule index n-1-t. sigma is
    # the same for every row, so its embedding and the FiLM coefficients are
    # computed at batch 1 and broadcast.
    sig_rev = torch.sqrt(alpha_set).flip(0)[:, None]  # [n, 1]
    sigma_embs = [model.embed_sigma(sig_rev[t:t + 1]) for t in range(n)]
    films = [model.precompute_film(se) for se in sigma_embs]

    def encode_all(t_ids, s):
        pre = model.encode_cond_pre(t_ids, s)
        return [model.encode_cond_tail(pre, se) for se in sigma_embs]

    cond_all = encode_all(text, style)
    text_mask = create_padding_mask(text)
    guided = guidance_scale is not None
    if guided:
        null_text = torch.zeros_like(text)
        null_text[:, 0] = 1
        null_cond_all = encode_all(null_text, torch.zeros_like(style))
        null_mask = create_padding_mask(null_text)

    def unet(x, cond, t, mask):
        kvs = model.precompute_cross_kv(cond, sigma_embs[t])
        return model.denoise(x, None, None, mask, kvs=kvs, films=films[t])

    def denoise(x, sigma, t):
        eps_c, pen = unet(x, cond_all[t], t, text_mask)
        if not guided:
            return eps_c, pen
        eps_u, _ = unet(x, null_cond_all[t], t, null_mask)
        return eps_u + guidance_scale * (eps_c - eps_u), pen

    return diffusion_sample(
        denoise, text.shape[0], seq_len, beta_set, mode=mode, generator=generator,
        x_init=x_init, noises=noises, temperature=temperature, device=dev,
    )


def sample_lines(
    model,
    prompts: list[str],
    style,  # [1 or B, 14, 1280]
    generator: torch.Generator | None = None,
    max_text_len: int = 50,
    diffusion_mode: str = "new",
    guidance_scale: float | None = None,
    n_steps: int | None = None,
    schedule: str = "strided",
    temperature: float | None = None,
    device: str | torch.device = "cuda",
) -> list[np.ndarray]:
    """Sample many prompts in one padded batch; each returned [T_i, 3] array
    is trimmed to its own 16 * len(tokens) length."""
    text = Tokenizer().encode_batch(prompts, max_text_len)
    style = torch.as_tensor(style, dtype=torch.float32)
    if style.shape[0] == 1 and len(prompts) > 1:
        style = style.expand(len(prompts), *style.shape[1:])
    lengths = [len(p) + 1 for p in prompts]  # + EOS
    out = generate(
        model, text, style, generator, seq_len=infer_seq_len(max(lengths)),
        diffusion_mode=diffusion_mode, guidance_scale=guidance_scale, n_steps=n_steps,
        schedule=schedule, temperature=temperature, device=device,
    )
    arr = out.cpu().numpy()
    return [arr[i, : infer_seq_len(l)] for i, l in enumerate(lengths)]
