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

The random init (lecun_init) follows flax's defaults, as dhg's trunk
draws it where no weights file is given: every conv kernel is
lecun_normal, a normal truncated to [-2 sigma, 2 sigma] with variance
1 / fan_in (flax's variance_scaling(1, "fan_in", "truncated_normal")),
fan_in = kh kw cin / groups; BatchNorm starts at weight 1, bias 0, mean 0,
var 1. torch's own conv init (kaiming-uniform, std 1 / sqrt(3 fan_in))
would shrink the signal by about sqrt(3) at each of the trunk's 52 convs,
BatchNorm on fixed statistics never renormalising it. The draws come from
a torch.Generator: the distribution is flax's, the bits are not jax's.
"""

from __future__ import annotations

import torch
from torch import nn

# flax's variance_scaling divides the target std by the std of a unit normal
# truncated to [-2, 2], so that the truncated draw has exactly that std.
TRUNCATED_NORMAL_STD = 0.87962566103423978

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


@torch.no_grad()
def lecun_init(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """flax's default init for every Conv2d and Linear under `module`, in
    module order: lecun_normal kernels (fan_in = weight[0].numel(): a
    Linear's in, a Conv2d's cin / groups x kh x kw), zero biases. BatchNorm
    keeps torch's init (weight 1, bias 0, running mean 0 and var 1), as
    flax's."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            std = (1.0 / mod.weight[0].numel()) ** 0.5 / TRUNCATED_NORMAL_STD
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()


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
