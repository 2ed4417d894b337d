"""Kernel selection (port of dhg/kernels/runtime.py::fused_bottleneck_mode).

DHG_FUSED_BOTTLENECK gates both sampler kernels, fused_bottleneck and
fused_encoder_layer:
  * "auto" (default): on for CUDA tensors at the canonical d = 384
    bottleneck, off on the CPU;
  * "1": on for any shape and device — on the CPU the wrappers then run
    their plain PyTorch versions, which is how the tests drive this path;
  * "0": off.
dhg's `rows` packing and DHG_SDPA_BATCHED are TPU lowering choices with
identical output; they have no counterpart here.
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
