"""Multi-head attention and sinusoidal positional embeddings (port of
dhg/ops/attention.py).

  * pos_embeddings: freq = exp(arange(half) * -ln(10000)/(half-1)), phase
    scaled by pos_factor, concat(sin, cos), computed in float32 then cast;
  * SDPA: additive mask * -1e9 (1.0 flags a padded key), softmax in float32,
    logits divided by sqrt(depth) in the compute dtype, heads BHTD.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dhg_torch.ops.basic import Linear


def pos_embeddings(
    length: int,
    dim: int,
    pos_factor: float = 1.0,
    dtype=torch.float32,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """Sinusoidal positional embeddings, [1, length, dim]."""
    half = dim // 2
    f32 = torch.float32
    freqs = torch.exp(
        torch.arange(half, dtype=f32, device=device) * -(math.log(10000.0) / (half - 1))
    )
    phase = torch.arange(length, dtype=f32, device=device)[:, None] * freqs[None, :] * pos_factor
    emb = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)
    return emb[None].to(dtype)


def sdpa(q, k, v, mask=None):
    """softmax(q k^T / sqrt(d) + mask * -1e9) v over [B, H, T, D] tensors."""
    # sqrt(depth) rounded to the compute dtype, as jnp.sqrt(asarray(depth, dtype)),
    # made on the host: a device scalar would cost a copy per call.
    denom = torch.tensor(float(q.shape[-1])).sqrt().to(q.dtype).item()
    logits = torch.matmul(q, k.transpose(-1, -2)) / denom
    if mask is not None:
        logits = logits + (mask * -1e9).to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


class MultiHeadAttention(nn.Module):
    """Separate wq/wk/wv/dense projections; `kv` and `attend_kv` split the
    key/value side off so the sampler can build it once per step."""

    def __init__(self, d_model: int, num_heads: int, dtype=None):
        super().__init__()
        self.d_model, self.num_heads, self.dtype = d_model, num_heads, dtype
        self.wq = Linear(d_model, d_model)
        self.wk = Linear(d_model, d_model)
        self.wv = Linear(d_model, d_model)
        self.dense = Linear(d_model, d_model)

    def _split_heads(self, y: torch.Tensor) -> torch.Tensor:
        """[B, L, D] -> [B, H, L, hd] (contiguous)."""
        b = y.shape[0]
        depth = self.d_model // self.num_heads
        return y.reshape(b, -1, self.num_heads, depth).transpose(1, 2).contiguous()

    def kv(self, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """([B,L,d], [B,L,d]) -> 2x [B,H,L,hd]."""
        return (
            self._split_heads(self.wk(k, self.dtype)),
            self._split_heads(self.wv(v, self.dtype)),
        )

    def attend_kv(self, q, kh, vh, mask=None) -> torch.Tensor:
        """Attention with pre-projected keys/values ([B,H,L,hd])."""
        b = q.shape[0]
        qh = self._split_heads(self.wq(q, self.dtype))
        out = sdpa(qh, kh, vh, mask)
        out = out.transpose(1, 2).reshape(b, -1, self.d_model)
        return self.dense(out, self.dtype)

    def forward(self, q, k, v, mask=None) -> torch.Tensor:
        kh, vh = self.kv(k, v)
        return self.attend_kv(q, kh, vh, mask)
