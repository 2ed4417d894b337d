"""Frozen style extractor (port of dhg/models/style_extractor.py): a grey
line image -> [B, 14, 1280] style vector, float32.

  * input scaled to [-1, 1] (x / 127.5 - 1), repeated to 3 channels;
  * the MobileNetV2 `features` trunk, BatchNorm on its running statistics;
  * AvgPool2d(kernel 3, stride 3), floor mode;
  * an average over H, then 14 width bins [floor(i W / 14), ceil((i + 1) W /
    14)) as one [W, 14] matrix product (torch's AdaptiveAvgPool2d((1, 14)));
  * channels last.

Weights come from dhg's flat .npz ({'/'.join(flax path): array}; the repo
carries data/style_trunk_synth.npz and data/style_trunk_tree.npz). Where the
file is missing the trunk is random, with a loud UserWarning, as in dhg
(strict=True raises instead); the default path, data/mobilenetv2_tv.npz (the
converted ImageNet weights), is absent from the repo.
"""

from __future__ import annotations

import logging
import warnings
from pathlib import Path

import numpy as np
import torch
from torch import nn

from dhg_torch import resolve_device
from dhg_torch.models.mobilenetv2 import MobileNetV2Features, lecun_init

logger = logging.getLogger(__name__)

STYLE_LEN = 14
STYLE_DIM = 1280
DEFAULT_WEIGHTS_PATH = Path(__file__).resolve().parents[2] / "data" / "mobilenetv2_tv.npz"


def width_bins(w: int, out_w: int = STYLE_LEN) -> torch.Tensor:
    """[w, out_w] float32 averaging matrix of torch's adaptive pooling."""
    starts = np.floor(np.arange(out_w) * w / out_w).astype(np.int64)
    ends = np.ceil((np.arange(out_w) + 1) * w / out_w).astype(np.int64)
    cols = np.arange(w)[:, None]
    weights = ((cols >= starts[None]) & (cols < ends[None])).astype(np.float32)
    return torch.from_numpy(weights / weights.sum(axis=0, keepdims=True))


class StyleExtractor(nn.Module):
    """[B, H, W] grey (0..255 floats) -> [B, 14, 1280] float32."""

    def __init__(self):
        super().__init__()
        self.mobilenet = MobileNetV2Features()

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.float() / 127.5 - 1.0
        x = x[:, None].expand(-1, 3, -1, -1)  # [B, 3, H, W]
        x = self.mobilenet(x)  # [B, 1280, h, w]
        x = nn.functional.avg_pool2d(x, 3, 3)  # floor mode
        x = x.mean(dim=2)  # [B, 1280, w]
        bins = width_bins(x.shape[-1]).to(x.device)
        return torch.einsum("bcw,wo->boc", x, bins)


def random_style_extractor(generator: torch.Generator) -> StyleExtractor:
    """A StyleExtractor on the CPU with flax's default init drawn from
    `generator` (mobilenetv2.lecun_init); train mode, gradients on."""
    with torch.random.fork_rng(devices=[]):  # torch's own init draws from the global stream
        model = StyleExtractor()
    lecun_init(model, generator)
    return model


def init_style_extractor(weights_path: str | Path | None = None, seed: int = 0,
                         strict: bool = False, device: str | torch.device = "cuda"
                         ) -> StyleExtractor:
    """The frozen extractor in eval mode on `device`.

    weights_path: dhg's flat .npz; None resolves to DEFAULT_WEIGHTS_PATH.
    If the file is absent the trunk keeps its random init, flax's defaults
    drawn from a generator seeded with `seed` (mobilenetv2.lecun_init), and
    a loud warning is emitted (the reference runs pretrained features,
    so its style vectors diverge completely); strict=True raises instead."""
    from dhg_torch.weights import style_state_dict_from_flat

    dev = resolve_device(device)
    model = random_style_extractor(torch.Generator().manual_seed(seed))
    resolved = Path(weights_path) if weights_path is not None else DEFAULT_WEIGHTS_PATH
    if resolved.exists():
        with np.load(resolved) as flat:
            model.load_state_dict(style_state_dict_from_flat(dict(flat)), strict=True)
    else:
        msg = (
            f"MobileNetV2 weights not found at {resolved} — the StyleExtractor "
            "is RANDOM-INITIALIZED and its style vectors will not match the "
            "reference's pretrained features. Convert torchvision weights with "
            "`python -m dhg_torch.tools.convert_torchvision_mnv2` or pass "
            "strict=False knowingly."
        )
        if strict:
            raise FileNotFoundError(msg)
        warnings.warn(msg, UserWarning, stacklevel=2)
        logger.warning(msg)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
    return model.to(dev).eval().requires_grad_(False)
