"""What the sampler measurement tools share: the model they sample, their
inputs and how they time a call.

dhg's tools time "chained dispatch, one D2H fence": N calls queued, then
one wait for the device. Here that is the host clock around N calls and
one torch.cuda.synchronize(); on the CPU every call is already done when
it returns. Every report names its backend ("cuda" or "cpu").
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dhg_torch import resolve_device

CANONICAL = {"channels": 128, "att_layers_num": 2}  # configs/base.yml's widths


def backend(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "cpu"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(fn, device: torch.device) -> None:
    """Two calls of `fn(i)` (i = -2, -1) before it is timed: on CUDA a
    `generate` key's first call runs eagerly and its second captures the
    key's CUDA graph, so every timed call after them is a replay."""
    for i in (-2, -1):
        fn(i)
    synchronize(device)


def seconds_per_call(fn, iters: int, device: torch.device) -> float:
    """Mean seconds per call of `iters` calls queued back to back, the host
    clock stopped after one synchronise (warm up before calling this:
    `warm_up` for a `generate` key)."""
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    synchronize(device)
    return (time.perf_counter() - t0) / iters


def load_model(kw: dict, device: torch.device, dtype=torch.bfloat16):
    """The model a tool samples: --experiment_path's checkpoint in float32,
    as dhg's load_model loads it, else random weights (seed 0) at the
    canonical widths in `dtype`, as dhg's tools init theirs."""
    from dhg_torch.checkpoint import resolve_checkpoint
    from dhg_torch.models.denoiser import DiffusionModel

    exp = kw.get("experiment_path")
    if exp:
        ckpt = resolve_checkpoint(exp)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {exp}")
        return DiffusionModel.load(ckpt, device=device)
    return DiffusionModel.from_config(CANONICAL, dtype=dtype, device=device, seed=0)


def random_inputs(batch: int, device: torch.device, prompt_len: int | None = None):
    """Token ids [B, 50] in 1..72, zero from `prompt_len` on, and style
    features [B, 14, 1280] ~ N(0, 1), from seeds 1 and 2 (numpy; dhg draws
    the same shapes and ranges with jax.random)."""
    text = np.random.RandomState(1).randint(1, 73, (batch, 50))
    if prompt_len is not None:
        text[:, prompt_len:] = 0
    style = np.random.RandomState(2).randn(batch, 14, 1280).astype(np.float32)
    return (torch.from_numpy(text).to(device),
            torch.from_numpy(style).to(device))


def tool_device(kw: dict) -> torch.device:
    """--device (default cuda; raises without CUDA unless --device=cpu)."""
    return resolve_device(kw.pop("device", "cuda"))
