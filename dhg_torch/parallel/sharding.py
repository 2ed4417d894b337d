"""Tensor-parallel rules and collectives over the model group (port of
dhg/parallel/sharding.py).

dhg's rules (`_spec_for`), keyed by the port's state_dict names, in the
port's [out, in] layout (weights.py):

  * FFN fc1 (Sequential index .1 of every *ffn): weight dim 0 and bias
    sharded — each rank owns a slice of the hidden;
  * FFN fc2 (.3): weight dim 1 sharded; its bias is replicated;
  * attention wq / wk / wv: weight dim 0 and bias sharded (by head);
  * attention output `dense`: weight dim 1 sharded;
  * everything else replicated.

Shards are equal contiguous slices of the sharded dim, rank m of the model
group holding slice m: dhg's layout. `shard_model` gives each FFN and
MultiHeadAttention the model group; their forward then runs Megatron's
pair (ops/basic.py FFN, ops/attention.py MultiHeadAttention): `copy_to`
(identity forward, all-reduce backward) on the input of the sharded
projections, `reduce_from` (all-reduce forward, identity backward) on the
output of fc2 / dense, the replicated bias added once after the sum. An
attention whose heads split evenly over the group attends on its local
heads; one whose heads do not (enc3's 3 at model_parallel 2) gathers its
q/k/v columns (`gather_from`), attends on every head and hands dense its
own columns (`scatter_to`): the same function either way.

Collectives run as all-reduce only (a gather is a sum of zero-padded
slices): gloo has no all-gather for CUDA tensors, and two processes that
share one card run gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

QKV = ("wq", "wk", "wv")


def shard_dim(name: str) -> int | None:
    """The dim of state_dict tensor `name` sharded over the model axis, or
    None where it is replicated."""
    parts = name.split(".")
    if len(parts) < 3:
        return None
    grand, parent, leaf = parts[-3:]
    if grand.endswith("ffn"):
        if parent == "1":
            return 0
        if parent == "3" and leaf == "weight":
            return 1
    if grand.startswith("mha"):
        if parent in QKV:
            return 0
        if parent == "dense" and leaf == "weight":
            return 1
    return None


def _slice(t: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does not split {size} ways")
    return t.chunk(size, dim)[index]


def shard_state_dict(sd: dict, index: int, size: int) -> dict:
    """Model rank `index`'s share of a full state_dict (or of any dict keyed
    by parameter names, as the optimizer's moments)."""
    return {name: t if shard_dim(name) is None or size == 1
            else _slice(t, shard_dim(name), index, size).contiguous() for name, t in sd.items()}


def all_gather_dim(t: torch.Tensor, dim: int, group, sizes: list[int] | None = None
                   ) -> torch.Tensor:
    """Concatenate every group rank's `t` along `dim` (slices of `sizes`, by
    default equal ones), through one all-reduce of zero-padded copies."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    sizes = sizes or [t.shape[dim]] * n
    full = list(t.shape)
    full[dim] = sum(sizes)
    out = t.new_zeros(full)
    out.narrow(dim, sum(sizes[:me]), sizes[me]).copy_(t)
    dist.all_reduce(out, group=group)
    return out


def gather_state_dict(sd: dict, group) -> dict:
    """The full state_dict from every model rank's share (a collective: each
    rank of the group calls it); the inverse of shard_state_dict."""
    if group is None:
        return dict(sd)
    out = {}
    for name, t in sd.items():
        dim = shard_dim(name)
        out[name] = t if dim is None else all_gather_dim(t.detach(), dim, group)
    return out


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """Concatenate the ranks' last-dim slices; the backward keeps this
    rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x.contiguous(), -1, group)

    @staticmethod
    def backward(ctx, g):
        n, me = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, -1)[me].contiguous(), None


class _ScatterTo(torch.autograd.Function):
    """This rank's last-dim slice; the backward concatenates the ranks'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, me = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, -1)[me].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), -1, ctx.group), None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def gather_from(x, group):
    return _GatherFrom.apply(x, group)


def scatter_to(x, group):
    return _ScatterTo.apply(x, group)


@torch.no_grad()
def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Cut `model`'s sharded parameters down to this rank's slices and hand
    its FFNs and attentions the model group (in place; returns the model).
    A mesh without a model group leaves the model as it is."""
    from dhg_torch.ops.attention import MultiHeadAttention
    from dhg_torch.ops.basic import FFN

    group = mesh.model_group
    if group is None:
        return model
    index, size = mesh.model_index, mesh.model_size
    for name, p in model.named_parameters():
        dim = shard_dim(name)
        if dim is not None:
            p.data = _slice(p.data, dim, index, size).contiguous().clone()
    for mod in model.modules():
        if isinstance(mod, (FFN, MultiHeadAttention)):
            mod.tp_group = group
    return model


def is_sharded(model: nn.Module) -> bool:
    """Whether shard_model has cut this model's weights."""
    return any(getattr(m, "tp_group", None) is not None for m in model.modules())
