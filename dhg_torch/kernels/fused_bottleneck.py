"""The sampler's attention kernels: wrappers, plain versions, launch counts.

fused_bottleneck
    Replaces dhg/kernels/fused_bottleneck.py::fused_bottleneck: att_dense
    [B, T8, Cin] -> [B, T8, D], then the whole att_layers stack.
fused_encoder_layer
    Replaces dhg/kernels/fused_bottleneck.py::fused_encoder_layer: one
    EncoderLayer.attend (enc3 at T/2 and enc5 at T/4 in the sampler).

Both run csrc/encoder_layer.cu on CUDA tensors (one block per batch row,
mma.sync tensor-core tiles, weights streamed from L2/HBM; see the source's
note for what bounds it). On an H100 the bottleneck is tensor-core bound at
batch 96-256 (~314 MFLOP a row at T8 = 49) and weight-bandwidth bound at
batch 1 (~6.3 MB of bf16 weights), where one block fills 1 SM of 132.

Beside each wrapper sits its plain PyTorch version with the kernel's
rounding points (dhg's `_encoder_layer`): bf16 products with f32
accumulation rounded once, then `+ bias` in bf16; bf16 logits times
bf16(1/sqrt(hd)) plus the mask bias; f32 softmax; f32 LayerNorm statistics;
f32 SiLU; bf16 FiLM. A wrapper takes the plain version only for CPU
tensors; a CUDA tensor gets the kernel or an exception. Both kernels are
forward-only, as in dhg: the wrappers refuse to run under autograd.

`launches` counts kernel launches (never the plain versions).

Operands per layer, in dhg's _PER_LAYER order, all bf16 and contiguous:
kh, vh [B, H, L, hd]; wq, bq, wo, bo, wq2, bq2, wk2, bk2, wv2, bv2, wo2, bo2
([D, D] torch Linear layout, [D]); w1 [2D, D], b1 [2D]; w2 [D, 2D], b2 [D];
g1, be1, g2, be2, g3, be3 [D] (FiLM at batch 1, broadcast over the batch).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

PER_LAYER = 24
BF16 = torch.bfloat16

launches = {"fused_bottleneck": 0, "fused_encoder_layer": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


# -- plain PyTorch versions -------------------------------------------------


def _dense(x, w, b):
    """bf16 product (f32 accumulation, one rounding), then + bias in bf16."""
    return torch.matmul(x, w.t()) + b


def _silu(x):
    xf = x.float()
    return (xf * (1.0 / (1.0 + torch.exp(-xf)))).to(BF16)


def _layer_norm(x, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(BF16)


def _heads(y, num_heads):
    b, t, d = y.shape
    return y.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _attention(q, kh, vh, num_heads, neg=None):
    """q [B, T, D]; kh, vh [B, H, L, hd]; neg [B, 1, L] or None -> [B, T, D]."""
    b, t, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d // num_heads)).to(BF16).item()  # bf16(scale)
    logits = torch.matmul(_heads(q, num_heads), kh.transpose(-1, -2)) * scale
    if neg is not None:
        logits = logits + neg[:, None]
    lf = logits.float()
    lf = lf - lf.amax(dim=-1, keepdim=True)
    e = torch.exp(lf)
    w = (e / e.sum(dim=-1, keepdim=True)).to(BF16)
    return torch.matmul(w, vh).transpose(1, 2).reshape(b, t, d)


def encoder_layer_plain(x, pe, neg, ops: Sequence[torch.Tensor], num_heads: int):
    """One EncoderLayer.attend with the kernel's rounding points."""
    (kh, vh, wq, bq, wo, bo, wq2, bq2, wk2, bk2, wv2, bv2, wo2, bo2,
     w1, b1, w2, b2, g1, be1, g2, be2, g3, be3) = ops
    x_pe = x + pe
    att = _attention(_dense(x_pe, wq, bq), kh, vh, num_heads, neg)
    x2 = _layer_norm(_dense(att, wo, bo)) * g1 + be1 + x

    x2_pe = x2 + pe
    q2, k2, v2 = _dense(x2_pe, wq2, bq2), _dense(x2_pe, wk2, bk2), _dense(x2, wv2, bv2)
    att2 = _attention(q2, _heads(k2, num_heads), _heads(v2, num_heads), num_heads)
    x3 = _layer_norm(x2 + _dense(att2, wo2, bo2)) * g2 + be2

    h = _dense(_silu(x3), w1, b1)
    x4 = _dense(_silu(h), w2, b2) + x3
    return _layer_norm(x4) * g3 + be3


def bottleneck_plain(x, att_w, att_b, pe, neg, ops, num_layers: int, num_heads: int):
    """att_dense, then num_layers EncoderLayers (the plain version)."""
    h = _dense(x, att_w, att_b)
    for i in range(num_layers):
        h = encoder_layer_plain(h, pe, neg, ops[i * PER_LAYER:(i + 1) * PER_LAYER], num_heads)
    return h


# -- checks shared by both paths --------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensor(name, t, shape, device):
    _require(isinstance(t, torch.Tensor), f"{name}: expected a tensor")
    _require(t.dtype == BF16, f"{name}: expected bfloat16, got {t.dtype}")
    _require(t.device == device, f"{name}: on {t.device}, expected {device}")
    _require(tuple(t.shape) == tuple(shape), f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    _require(t.is_contiguous(), f"{name}: must be contiguous")


def _check_layer(ops, b, t, d, num_heads, l, device, prefix=""):
    _require(len(ops) == PER_LAYER, f"{prefix}expected {PER_LAYER} operands, got {len(ops)}")
    hd = d // num_heads
    shapes = [(b, num_heads, l, hd)] * 2 + [(d, d), (d,)] * 6
    shapes += [(2 * d, d), (2 * d,), (d, 2 * d), (d,)] + [(d,)] * 6
    names = ["kh", "vh", "wq", "bq", "wo", "bo", "wq2", "bq2", "wk2", "bk2", "wv2", "bv2",
             "wo2", "bo2", "w1", "b1", "w2", "b2", "g1", "be1", "g2", "be2", "g3", "be3"]
    for name, op, shape in zip(names, ops, shapes):
        _check_tensor(prefix + name, op, shape, device)


def _check_common(x, pe, neg, d, num_heads):
    _require(x.dim() == 3, f"x: expected [B, T, C], got {tuple(x.shape)}")
    _require(x.device.type in ("cpu", "cuda"), f"x: unsupported device {x.device}")
    _require(d % 16 == 0 and num_heads > 0 and d % num_heads == 0
             and (d // num_heads) % 16 == 0,
             f"width {d} with {num_heads} heads: need width and head dim multiples of 16")
    b, t = x.shape[:2]
    _require(neg.dim() == 3 and neg.shape[1] == 1, f"neg: expected [B, 1, L], got {tuple(neg.shape)}")
    _check_tensor("pe", pe, (t, d), x.device)
    _check_tensor("neg", neg, (b, 1, neg.shape[2]), x.device)
    return b, t, neg.shape[2]


def _forward_only(tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("dhg_torch kernels are forward-only; run under torch.no_grad()")


def _ptrs(ops) -> ctypes.Array:
    return (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])


# -- the wrappers -------------------------------------------------------------


def fused_encoder_layer(x, pe, neg, layer_ops: Sequence[torch.Tensor], num_heads: int):
    """One EncoderLayer.attend: x [B, T, D] bf16 -> [B, T, D] bf16."""
    d = x.shape[-1]
    b, t, l = _check_common(x, pe, neg, d, num_heads)
    _check_tensor("x", x, (b, t, d), x.device)
    _check_layer(layer_ops, b, t, d, num_heads, l, x.device)
    if x.device.type == "cpu":
        return encoder_layer_plain(x, pe, neg, layer_ops, num_heads)
    _forward_only([x, pe, neg, *layer_ops])
    from dhg_torch.kernels.build import check_rc, load

    lib = load()
    ws = torch.empty(b * lib.dhg_workspace_elems(t, d, l), dtype=BF16, device=x.device)
    out = torch.empty_like(x)
    ptrs = _ptrs(layer_ops)
    rc = lib.dhg_fused_encoder_layer(
        x.data_ptr(), pe.data_ptr(), neg.data_ptr(), ptrs, out.data_ptr(), ws.data_ptr(),
        b, t, d, num_heads, l, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_rc(lib, rc, "fused_encoder_layer")
    launches["fused_encoder_layer"] += 1
    return out


def fused_bottleneck(x, att_w, att_b, pe, neg, layer_ops: Sequence[torch.Tensor],
                     num_layers: int, num_heads: int = 6):
    """att_dense + num_layers EncoderLayers: x [B, T8, Cin] -> [B, T8, D] bf16."""
    d, cin = att_w.shape[0], x.shape[-1]
    b, t, l = _check_common(x, pe, neg, d, num_heads)
    _require(cin % 16 == 0, f"x: input width {cin} must be a multiple of 16")
    _require(1 <= num_layers <= 8, f"num_layers {num_layers} outside [1, 8]")
    _check_tensor("x", x, (b, t, cin), x.device)
    _check_tensor("att_w", att_w, (d, cin), x.device)
    _check_tensor("att_b", att_b, (d,), x.device)
    _require(len(layer_ops) == num_layers * PER_LAYER,
             f"expected {num_layers * PER_LAYER} layer operands, got {len(layer_ops)}")
    for i in range(num_layers):
        _check_layer(layer_ops[i * PER_LAYER:(i + 1) * PER_LAYER], b, t, d, num_heads, l,
                     x.device, prefix=f"layer {i}: ")
    if x.device.type == "cpu":
        return bottleneck_plain(x, att_w, att_b, pe, neg, layer_ops, num_layers, num_heads)
    _forward_only([x, att_w, att_b, pe, neg, *layer_ops])
    from dhg_torch.kernels.build import check_rc, load

    lib = load()
    ws = torch.empty(b * lib.dhg_workspace_elems(t, d, l), dtype=BF16, device=x.device)
    out = torch.empty((b, t, d), dtype=BF16, device=x.device)
    ptrs = _ptrs(layer_ops)
    rc = lib.dhg_fused_bottleneck(
        x.data_ptr(), att_w.data_ptr(), att_b.data_ptr(), pe.data_ptr(), neg.data_ptr(), ptrs,
        num_layers, out.data_ptr(), ws.data_ptr(), b, t, cin, d, num_heads, l,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_rc(lib, rc, "fused_bottleneck")
    launches["fused_bottleneck"] += 1
    return out
