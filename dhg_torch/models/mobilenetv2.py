"""MobileNetV2 feature trunk (port of dhg/models/mobilenetv2.py), NCHW.

  Conv 3x3 s2 -> 32 | inverted residual stages (t, c, n, s):
  (1,16,1,1) (6,24,2,2) (6,32,3,2) (6,64,4,2) (6,96,3,1) (6,160,3,2)
  (6,320,1,1) | Conv 1x1 -> 1280, each conv followed by BatchNorm (eps 1e-5,
  always on its running statistics) and ReLU6, except the projections.

Padding is explicit and symmetric, (k - 1) // 2 a side, as in dhg and
torchvision. The depthwise convs are grouped nn.Conv2d: these were XLA convs
in dhg, not Pallas kernels. Module names follow dhg's flax names
(stem, block_<stage>_<i>.{expand,dw,project,project_bn}, head), so
dhg_torch.weights.style_state_dict_from_flat maps a dhg .npz onto them.
On CUDA the caller keeps TF32 off (cudnn.allow_tf32 = False).
"""

from __future__ import annotations

import torch
from torch import nn

# (expansion t, out channels c, repeats n, first stride s)
INVERTED_RESIDUAL_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.bn(self.conv(x)), 0.0, 6.0)  # ReLU6


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.expand = ConvBNReLU(cin, hidden, kernel=1) if expand != 1 else None
        self.dw = ConvBNReLU(hidden, hidden, kernel=3, stride=stride, groups=hidden)
        self.project = nn.Conv2d(hidden, cout, 1, bias=False)
        self.project_bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.expand(x) if self.expand is not None else x
        h = self.project_bn(self.project(self.dw(h)))
        return x + h if self.use_res else h


class MobileNetV2Features(nn.Module):
    """The `features` trunk: [B, 3, H, W] -> [B, 1280, H/32, W/32]."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBNReLU(3, 32, kernel=3, stride=2)
        cin = 32
        self.block_names = []
        for stage, (t, c, n, s) in enumerate(INVERTED_RESIDUAL_SETTINGS):
            for i in range(n):
                name = f"block_{stage}_{i}"
                self.add_module(name, InvertedResidual(cin, c, s if i == 0 else 1, t))
                self.block_names.append(name)
                cin = c
        self.head = ConvBNReLU(cin, 1280, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x)
