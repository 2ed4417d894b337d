"""Basic blocks (port of dhg/ops/basic.py): Dense with dhg's rounding,
FiLM affines, the SiLU FFN, LayerNorm, masks and reshapes.

A `dtype` of torch.bfloat16 reproduces flax's Dense(dtype=bf16): inputs and
weights cast to bf16, one bf16 product with f32 accumulation, rounded once,
then `+ bias` in bf16 — two roundings, so no fused addmm. Parameters stay
float32; the bf16 copies are cached per weight version when no gradient is
being recorded, so the sampler casts each weight once, not once per step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class CastCache:
    """Mixin: `self._cached(dtype, make)` returns make(dtype), memoized on the
    parameters' storage and version (load_state_dict / .to() invalidate it).
    Nothing is cached while autograd records, so gradients still flow."""

    _cache_key = None
    _cache_val = None

    def _cached(self, dtype, make):
        if torch.is_grad_enabled():
            return make(dtype)
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._cache_key != key:
            self._cache_val, self._cache_key = make(dtype), key
        return self._cache_val


class Linear(CastCache, nn.Linear):
    """nn.Linear (weight [out, in]) applied with dhg's Dense rounding."""

    def cast(self, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight [out, in], bias [out]) in `dtype`, contiguous."""
        if self.weight.dtype == dtype:
            return self.weight, self.bias
        return self._cached(
            dtype, lambda dt: (self.weight.to(dt).contiguous(), self.bias.to(dt))
        )

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        dt = dtype or x.dtype
        w, b = self.cast(dt)
        return torch.matmul(x.to(dt), w.t()) + b


def layer_norm(x: torch.Tensor, dtype=None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm(eps=1e-6) without affine: float32 statistics with the fast
    variance max(0, E[x^2] - E[x]^2), result cast to `dtype` (or x.dtype)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dtype or x.dtype)


class AffineTransformLayer(nn.Module):
    """FiLM: x * gamma(sigma_emb) + beta(sigma_emb). The sigma embedding is
    c1 // 4 wide (32 at the canonical plan, narrower in small test models)."""

    def __init__(self, sigma_dim: int, hidden: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.gamma_emb = Linear(sigma_dim, hidden)
        self.beta_emb = Linear(sigma_dim, hidden)

    def coefficients(self, sigma_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(gamma [B, C], beta [B, C])."""
        return self.gamma_emb(sigma_emb, self.dtype), self.beta_emb(sigma_emb, self.dtype)

    @staticmethod
    def apply_coeffs(x: torch.Tensor, coeffs) -> torch.Tensor:
        gamma, beta = coeffs
        return x * gamma[:, None, :] + beta[:, None, :]

    def forward(self, x: torch.Tensor, sigma_emb: torch.Tensor) -> torch.Tensor:
        return self.apply_coeffs(x, self.coefficients(sigma_emb))


class FFN(nn.Sequential):
    """SiLU -> Linear(hidden) -> SiLU -> Linear(out); Sequential indices .1/.3
    hold the weights, as in the reference's ff_network."""

    def __init__(self, d_in: int, hidden: int, out: int, dtype=None):
        super().__init__(nn.SiLU(), Linear(d_in, hidden), nn.SiLU(), Linear(hidden, out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[1](F.silu(x), self.dtype)
        return self[3](F.silu(x), self.dtype)


def dropout(drop: nn.Dropout, x: torch.Tensor) -> torch.Tensor:
    """drop(x) under train() with p > 0, else x without the module call: the
    sampler runs these layers thousands of times a call, in eval."""
    return drop(x) if drop.training and drop.p else x


def create_padding_mask(tokens: torch.Tensor) -> torch.Tensor:
    """[B, L] ids -> [B, 1, 1, L] float32, 1.0 at padding (id 0)."""
    return (tokens == 0).to(torch.float32)[:, None, None, :]


def reshape_up(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[B, L, C] -> [B, L*factor, C//factor]."""
    b, l, c = x.shape
    return x.reshape(b, l * factor, c // factor)
