"""Kernel selection (port of dhg/kernels/runtime.py), with CUDA in place of
the TPU.

DHG_FUSED_BOTTLENECK gates both sampler kernels, fused_bottleneck and
fused_encoder_layer:
  * "auto" (default): on for CUDA tensors at the canonical d = 384
    bottleneck, off on the CPU;
  * "1": on for any shape and device — on the CPU the wrappers then run
    their plain PyTorch versions, which is how the tests drive this path;
  * "0": off.
DHG_FUSED_ATTENTION and DHG_FUSED_CONVBLOCK gate the train-path kernels,
default "0" as in dhg. "1" routes every attention (ConvBlock) through its
kernel on CUDA tensors and through the kernel's plain version on CPU
tensors; the backward of both recomputes the plain math, so the flags are
safe for the sampler and the train step alike.
DHG_FUSED_T4 gates the sampler's fused_unet_t4 path, default "0" as in dhg.
dhg's `rows` packing and DHG_SDPA_BATCHED are TPU lowering choices with
identical output; they have no counterpart here. kernel_modes gathers the
four modes for a CUDA graph's key.

launch_counts / add_launches read and add to the wrappers' launch counts:
a CUDA graph's replay launches kernels that no wrapper sees.
"""

from __future__ import annotations

import os

import torch


def fused_bottleneck_mode(device: torch.device) -> str:
    """"off" | "on" | "auto" for activations on `device`."""
    v = os.environ.get("DHG_FUSED_BOTTLENECK", "auto")
    if v == "0":
        return "off"
    if v == "1":
        return "on"
    return "auto" if torch.device(device).type == "cuda" else "off"


def _flag_on(name: str, device: torch.device) -> bool:
    return os.environ.get(name, "0") == "1" and torch.device(device).type in ("cpu", "cuda")


def fused_t4_mode(device: torch.device) -> str:
    """"off" | "on": the whole T/4..T/8 region of the sampler's denoise in
    one fused_unet_t4 launch. DHG_FUSED_T4=1 turns it on (off by default,
    as in dhg): the kernel for CUDA tensors, its plain version for CPU ones.
    dhg's "auto" branch is unreachable there, so it has no counterpart."""
    return "on" if _flag_on("DHG_FUSED_T4", device) else "off"


def use_fused_attention(device: torch.device) -> bool:
    """Route attention on `device` through kernels/fused_attention.py."""
    return _flag_on("DHG_FUSED_ATTENTION", device)


def use_fused_conv_block(device: torch.device) -> bool:
    """Route ConvBlocks on `device` through kernels/fused_conv_block.py."""
    return _flag_on("DHG_FUSED_CONVBLOCK", device)


def kernel_modes(device: torch.device) -> tuple[str, str, bool, bool]:
    """(fused_bottleneck_mode, fused_t4_mode, use_fused_attention,
    use_fused_conv_block) for `device`: every mode the traced sampler and
    train paths read from the environment, call by call. A CUDA graph bakes
    in the path it captured, so a graph's key carries these."""
    return (fused_bottleneck_mode(device), fused_t4_mode(device),
            use_fused_attention(device), use_fused_conv_block(device))


def _launch_dicts() -> list[dict]:
    from dhg_torch.kernels import fused_attention, fused_bottleneck, fused_conv_block

    return [fused_attention.launches, fused_conv_block.launches, fused_bottleneck.launches]


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel name."""
    return {k: v for d in _launch_dicts() for k, v in d.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add `counts` (by kernel name) to the wrappers' launch counts: the
    launches of a CUDA graph's replay, which no wrapper sees."""
    for d in _launch_dicts():
        for k in d.keys() & counts.keys():
            d[k] += counts[k]
