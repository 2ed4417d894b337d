"""dhg_torch — the PyTorch/CUDA port of dhg for NVIDIA Hopper.

The layout mirrors `dhg/` so each module has an obvious counterpart:

  dhg_torch.core       — noise schedule, reverse-diffusion step rules, losses
  dhg_torch.ops        — LayerNorm, FiLM affines, FFN, attention, k3 convs
  dhg_torch.models     — text-style encoder, encoder layer, denoiser U-Net,
                         MobileNetV2 style extractor
  dhg_torch.kernels    — hand-written CUDA kernels (sm_90a) beside their
                         plain PyTorch versions
  dhg_torch.data       — the 73-id character tokenizer, training batches,
                         style images (PNG)
  dhg_torch.inference  — generate / sample_lines (the line sampler) and the
                         infer CLI (utils.vis renders PNG / SVG)
  dhg_torch.train      — the trainer and its CLI (with config, checkpoint,
                         eval and utils.experiment)
  dhg_torch.weights    — dhg params / exported .pth -> the port's state_dict

Activations stay channel-last [B, T, C] as in dhg. Entry points default to
device="cuda" and raise when CUDA is absent; pass device="cpu" explicitly to
run the plain PyTorch path (the tests do). Nothing falls back on its own.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `device`; raises if it names CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dhg_torch: CUDA is not available; pass device='cpu' to run the "
            "plain PyTorch path explicitly"
        )
    return dev
