"""1-D conv blocks, pooling and upsampling (port of dhg/ops/conv.py), all
channel-last [B, T, C].

The k3 'same' conv runs as ONE product [B, T, 3*Cin] @ [3*Cin, Co] of the
three shifted copies of x, so bf16 rounds once, as XLA's conv does, and the
f32 path does not go through cuDNN (whose f32 convs default to TF32).
ConvBlock keeps the reference's wiring (dhg's single-dilation quirk: every
block on this path has dilation 1). Dropout is the identity: the port runs
in eval only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dhg_torch.ops.basic import AffineTransformLayer, CastCache, Linear


class Conv3(CastCache, nn.Conv1d):
    """k3 'same' Conv1d (weight [out, in, 3]) over channel-last input."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out, kernel_size=3, padding=1)

    def _packed(self, dtype):
        # [out, in, k] -> [k*in, out]: row k*Cin + i multiplies x[t + k - 1, i].
        w = self.weight.permute(2, 1, 0).reshape(-1, self.out_channels)
        return w.to(dtype).contiguous(), self.bias.to(dtype)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        dt = dtype or x.dtype
        w, b = self._cached(dt, self._packed)
        xp = F.pad(x.to(dt), (0, 0, 1, 1))
        xcat = torch.cat([xp[:, :-2], xp[:, 1:-1], xp[:, 2:]], dim=-1)
        return torch.matmul(xcat, w) + b


def avg_pool_1d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """[B, T, C] -> [B, T//window, C] mean pooling."""
    b, t, c = x.shape
    return x.reshape(b, t // window, window, c).mean(dim=2)


def upsample_nearest_1d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[B, T, C] -> [B, T*factor, C] nearest-neighbour upsample."""
    return torch.repeat_interleave(x, factor, dim=1)


class ConvBlock(nn.Module):
    """skip = k3 conv(x); h = conv1(SiLU x) -> FiLM1 -> conv2(SiLU h) -> FiLM2
    -> fc(SiLU h) -> FiLM3; out = h + skip."""

    def __init__(self, d_in: int, d_out: int, sigma_dim: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv_skip = Conv3(d_in, d_out)
        self.conv1 = Conv3(d_in, d_out // 2)
        self.conv2 = Conv3(d_out // 2, d_out)
        self.fc = Linear(d_out, d_out)
        self.affine1 = AffineTransformLayer(sigma_dim, d_out // 2, dtype)
        self.affine2 = AffineTransformLayer(sigma_dim, d_out, dtype)
        self.affine3 = AffineTransformLayer(sigma_dim, d_out, dtype)

    def film_coeffs(self, sigma_emb: torch.Tensor):
        """(gamma, beta) for the three affines."""
        return (
            self.affine1.coefficients(sigma_emb),
            self.affine2.coefficients(sigma_emb),
            self.affine3.coefficients(sigma_emb),
        )

    def forward(self, x, sigma_emb=None, coeffs=None) -> torch.Tensor:
        if coeffs is None:
            coeffs = self.film_coeffs(sigma_emb)
        c1, c2, c3 = coeffs
        film = AffineTransformLayer.apply_coeffs
        dt = self.dtype
        skip = self.conv_skip(x, dt)
        h = film(self.conv1(F.silu(x), dt), c1)
        h = film(self.conv2(F.silu(h), dt), c2)
        h = film(self.fc(F.silu(h), dt), c3)
        return h + skip
