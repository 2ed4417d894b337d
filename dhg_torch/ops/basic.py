"""Basic blocks (port of dhg/ops/basic.py): Dense with dhg's rounding,
FiLM affines, the SiLU FFN, LayerNorm, masks and reshapes.

A `dtype` of torch.bfloat16 reproduces flax's Dense(dtype=bf16): inputs and
weights cast to bf16, one bf16 product with f32 accumulation, rounded once,
then `+ bias` in bf16 — two roundings, so no fused addmm. Parameters stay
float32; the bf16 copies are cached per weight version when no gradient is
being recorded, so the sampler casts each weight once, not once per step.

FFN is one seam of tensor parallelism (parallel/sharding.py): with a model
group its fc1 holds a slice of the hidden, fc2 the matching input columns.
Without one it is the plain module, op for op.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from dhg_torch.parallel.sharding import copy_to, reduce_from


class CastCache:
    """Mixin: `self._cached(dtype, make)` returns make(dtype), memoized per
    `make` (one slot for each layout a module hands out) on the dtype and the
    parameters' storage and version (load_state_dict / .to() invalidate it).
    `params` narrows the key to the parameters make reads (default: all of
    the module's). Nothing is cached while autograd records, so gradients
    still flow."""

    _cast_cache = None

    def _cached(self, dtype, make, params=None):
        if torch.is_grad_enabled():
            return make(dtype)
        params = self.parameters() if params is None else params
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if self._cast_cache is None:
            self._cast_cache = {}
        slot = self._cast_cache.get(make.__name__)
        if slot is None or slot[0] != key:
            slot = self._cast_cache[make.__name__] = (key, make(dtype))
        return slot[1]


def clear_cast_caches(model: nn.Module) -> None:
    """Drop every cached cast of `model`'s modules. A CUDA graph's replay
    updates the weights in place without bumping their `_version`, so the
    cache's key cannot see it: whoever replays one calls this after."""
    for m in model.modules():
        if isinstance(m, CastCache):
            m._cast_cache = None


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


class _EmbeddingFn(torch.autograd.Function):
    """F.embedding forward; the weight's gradient as one product,
    one_hot(ids)^T @ grad, summed in a fixed order."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        grad = grad.reshape(-1, grad.shape[-1])
        # A comparison, not F.one_hot, whose range check syncs with the host.
        rows = torch.arange(ctx.rows, device=ids.device)
        onehot = (ids.reshape(-1, 1) == rows).to(grad.dtype)
        return None, onehot.t() @ grad


class Embedding(nn.Embedding):
    """nn.Embedding whose weight gradient is reproducible: CUDA's own
    embedding backward sums a token's rows in an order that changes from run
    to run (last bits of the moments of a train step), and a replayed train
    step is held to the eager one bit for bit. The forward is F.embedding's
    gather on every path."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return _EmbeddingFn.apply(ids, self.weight)
        return F.embedding(ids, self.weight)


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
    hold the weights, as in the reference's ff_network. With `tp_group` set
    (parallel/sharding.py::shard_model) each rank holds a slice of the
    hidden: fc2's partial products are summed over the group, then fc2's
    bias added once."""

    tp_group = None

    def __init__(self, d_in: int, hidden: int, out: int, dtype=None):
        super().__init__(nn.SiLU(), Linear(d_in, hidden), nn.SiLU(), Linear(hidden, out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.tp_group
        if g is None:
            x = self[1](F.silu(x), self.dtype)
            return self[3](F.silu(x), self.dtype)
        h = F.silu(self[1](F.silu(copy_to(x, g)), self.dtype))
        dt = self.dtype or h.dtype
        w, b = self[3].cast(dt)
        return reduce_from(torch.matmul(h.to(dt), w.t()), g) + b


@contextmanager
def dropout_rows(model: nn.Module, total: int, rows: slice):
    """Inside, each live dropout of `model` draws its mask for a batch of
    `total` rows and keeps `rows`, the rows of this forward: a data-parallel
    rank then drops what a one-process run drops for the same rows, and the
    ranks of a model group drop alike, when the caller seeds the generator
    alike."""
    drops = [m for m in model.modules() if isinstance(m, nn.Dropout)]
    for m in drops:
        m.batch_rows = (total, rows)
    try:
        yield
    finally:
        for m in drops:
            del m.batch_rows


def dropout(drop: nn.Dropout, x: torch.Tensor) -> torch.Tensor:
    """drop(x) under train() with p > 0, else x without the module call: the
    sampler runs these layers thousands of times a call, in eval. Under
    dropout_rows the mask comes from the whole batch's draw."""
    if not (drop.training and drop.p):
        return x
    rows = getattr(drop, "batch_rows", None)
    if rows is None:
        return drop(x)
    mask = drop(torch.ones((rows[0],) + x.shape[1:], device=x.device))[rows[1]]
    return (x * mask).to(x.dtype)


def create_padding_mask(tokens: torch.Tensor) -> torch.Tensor:
    """[B, L] ids -> [B, 1, 1, L] float32, 1.0 at padding (id 0)."""
    return (tokens == 0).to(torch.float32)[:, None, None, :]


def reshape_up(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[B, L, C] -> [B, L*factor, C//factor]."""
    b, l, c = x.shape
    return x.reshape(b, l * factor, c // factor)
