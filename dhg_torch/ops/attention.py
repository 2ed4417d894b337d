"""Multi-head attention and sinusoidal positional embeddings (port of
dhg/ops/attention.py).

  * pos_embeddings: freq = exp(arange(half) * -ln(10000)/(half-1)), phase
    scaled by pos_factor, concat(sin, cos), computed in float32 then cast;
  * SDPA: additive mask * -1e9 (1.0 flags a padded key), softmax in float32,
    logits divided by sqrt(depth) in the compute dtype, heads BHTD
    (`sdpa_math`, dhg's _sdpa_jnp). With DHG_FUSED_ATTENTION=1, `sdpa` runs
    the forward through kernels/fused_attention.py and the backward through
    `sdpa_math`, as dhg's _sdpa_fused custom_vjp does; the kernel keeps the
    logits in float32, so in bf16 the two forwards agree at the bf16 bar.

MultiHeadAttention is a seam of tensor parallelism (parallel/sharding.py):
with a model group, wq/wk/wv hold a slice of the heads and dense the
matching input columns. Without one it is the plain module, op for op.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from dhg_torch.kernels.fused_attention import FusedAttention
from dhg_torch.kernels.runtime import use_fused_attention
from dhg_torch.ops.basic import Linear
from dhg_torch.parallel.sharding import copy_to, gather_from, reduce_from, scatter_to


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
    if use_fused_attention(q.device):
        return FusedAttention.apply(q, k, v, mask)
    return sdpa_math(q, k, v, mask)


def sdpa_math(q, k, v, mask=None):
    """The plain path (dhg's _sdpa_jnp); also the fused path's backward."""
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
    key/value side off so the sampler can build it once per step.

    With `tp_group` set (parallel/sharding.py::shard_model) each rank
    projects its slice of the q/k/v columns. Where the heads split evenly
    over the group, it attends on its local heads; else it gathers every
    head, attends, and keeps its own columns for dense. dense's partial
    products are summed over the group, then its bias added once."""

    tp_group = None

    def __init__(self, d_model: int, num_heads: int, dtype=None):
        super().__init__()
        self.d_model, self.num_heads, self.dtype = d_model, num_heads, dtype
        self.wq = Linear(d_model, d_model)
        self.wk = Linear(d_model, d_model)
        self.wv = Linear(d_model, d_model)
        self.dense = Linear(d_model, d_model)

    def _whole_heads(self) -> bool:
        """Whether this rank's q/k/v columns are whole heads."""
        return self.tp_group is None or self.num_heads % dist.get_world_size(self.tp_group) == 0

    def _split_heads(self, y: torch.Tensor) -> torch.Tensor:
        """[B, L, D] -> [B, H, L, hd] (contiguous); under a model group the
        projected columns of this rank's heads, or of every head."""
        if not self._whole_heads():
            y = gather_from(y, self.tp_group)
        b = y.shape[0]
        depth = self.d_model // self.num_heads
        return y.reshape(b, -1, y.shape[-1] // depth, depth).transpose(1, 2).contiguous()

    def kv(self, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """([B,L,d], [B,L,d]) -> 2x [B,H,L,hd]."""
        if self.tp_group is not None:
            k, v = copy_to(k, self.tp_group), copy_to(v, self.tp_group)
        return (
            self._split_heads(self.wk(k, self.dtype)),
            self._split_heads(self.wv(v, self.dtype)),
        )

    def attend_kv(self, q, kh, vh, mask=None) -> torch.Tensor:
        """Attention with pre-projected keys/values ([B,H,L,hd])."""
        b, g = q.shape[0], self.tp_group
        if g is not None:
            q = copy_to(q, g)
        qh = self._split_heads(self.wq(q, self.dtype))
        out = sdpa(qh, kh, vh, mask)
        out = out.transpose(1, 2).reshape(b, -1, out.shape[1] * out.shape[3])
        if g is None:
            return self.dense(out, self.dtype)
        if not self._whole_heads():
            out = scatter_to(out, g)
        dt = self.dtype or out.dtype
        w, bias = self.dense.cast(dt)
        return reduce_from(torch.matmul(out.to(dt), w.t()), g) + bias

    def forward(self, q, k, v, mask=None) -> torch.Tensor:
        kh, vh = self.kv(k, v)
        return self.attend_kv(q, kh, vh, mask)
