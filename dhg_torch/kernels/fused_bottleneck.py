"""The sampler's attention kernels: wrappers, plain versions, launch counts.

fused_bottleneck
    Replaces dhg/kernels/fused_bottleneck.py::fused_bottleneck: att_dense
    [B, T8, Cin] -> [B, T8, D], then the whole att_layers stack.
fused_encoder_layer
    Replaces dhg/kernels/fused_bottleneck.py::fused_encoder_layer: one
    EncoderLayer.attend (enc3 at T/2 and enc5 at T/4 in the sampler).
fused_unet_t4
    Replaces dhg/kernels/fused_bottleneck.py::fused_unet_t4: enc4, enc5,
    pool, the bottleneck, upsample, skip_conv3 and dec3 in one launch
    (DHG_FUSED_T4=1 only).

On CUDA tensors fused_bottleneck runs csrc/bottleneck.cu: one batch row
over a thread-block cluster of num_heads CTAs (sm_90a, at most 8), CTA h
computing head h's columns of every product, the row's activations in
shared memory (gathered through distributed shared memory; a row too long
for that spills its gathered operands to a global workspace), each CTA's
weight slices streamed through a ring of bulk (TMA) copies from a tiled
copy of the weights (bottleneck_tiles; 6.3 MB for the canonical model,
made once per weight set by DiffusionModel.bottleneck_tiles).
fused_encoder_layer runs csrc/encoder_layer.cu: one batch row over a
cluster of CTAs split by sequence rows (at most 64 rows a CTA, full width,
so every Dense, LayerNorm and the FFN stays in the CTA; the self-attention's
K/V are read from the peers through distributed shared memory), the layer's
weights streamed through the same ring from encoder_layer_tiles (made once
per weight set by DiffusionModel.encoder_layer_tiles). fused_unet_t4 runs
csrc/unet_t4.cu: one batch row over a cluster of CTAs split by sequence
rows (the fewest that fit, an even number of rows each: 2 CTAs of 50 and
48 rows at the canonical T/4 = 98), every stage on that split with the
row's activations in shared memory, k3 convs reading one halo row from
each neighbour through distributed shared memory, enc5 and the
bottleneck's layers as encoder_layer.cu's layer body, and all of the
region's weights streamed through one ring (encoder_layer_tiles of
t4_weights, made once per weight set by DiffusionModel.t4_tiles). On an
H100 the bottleneck is tensor-core bound at batch 96-256
(~314 MFLOP a row at T8 = 49) and weight-bandwidth bound at batch 1 (~6.3 MB
of bf16 weights). See the sources' notes for what bounds each.

Beside each wrapper sits its plain PyTorch version with the kernel's
rounding points (dhg's `_encoder_layer`): bf16 products with f32
accumulation rounded once, then `+ bias` in bf16; bf16 logits times
bf16(1/sqrt(hd)) plus the mask bias; f32 softmax; f32 LayerNorm statistics;
f32 SiLU; bf16 FiLM; in the T4 region's k3 convs, the three taps and the
bias summed in f32 and rounded once (dhg's `_conv3_packed`). A wrapper
takes the plain version only for CPU tensors; a CUDA tensor gets the kernel
or an exception. The kernels are forward-only, as in dhg: the wrappers
refuse to run under autograd.

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
import torch.nn.functional as F

from dhg_torch.kernels.build import MAX_SMEM

PER_LAYER = 24
PER_CONV = 14
MAX_LAYERS = 8  # kMaxLayers in csrc/bottleneck.cu and csrc/unet_t4.cu
MAX_CLUSTER = 8  # portable thread-block cluster size: fused_bottleneck's heads
MAX_HELD = 128  # bottleneck.cu: T and L of a row held in shared memory
MAX_ROWS = 256  # bottleneck.cu: T and L of a spilled row
TILE = 64  # bottleneck.cu's weight tiles are [64, 64] bf16 (64 output rows in both kernels)
RING_BYTES = 4 * TILE * TILE * 2  # its ring (tile_ring.cuh's Ring): kStages tiles
ENC_ROWS = 64  # encoder_layer.cu: sequence rows a CTA holds
ENC_CLUSTER = 16  # encoder_layer.cu: CTAs a row (non-portable above 8)
ENC_HEADS = 8
ENC_HEAD_DIM = 64
ENC_TILE_DEPTH = 128  # encoder_layer.cu's weight tiles are [64, 128] bf16, two in its ring
KEY_CHUNK = 64  # encoder_layer.cu: keys staged a chunk
HELD_KEYS = 256  # encoder_layer.cu: keys staged at once (one softmax pass)
ENC_WIDTH = 256  # encoder_layer.cu: widest row
T4_WIDTH = 384  # unet_t4.cu: widest EncoderLayer (c3 and the bottleneck's d)
BF16 = torch.bfloat16

launches = {"fused_bottleneck": 0, "fused_encoder_layer": 0, "fused_unet_t4": 0}


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


def _conv3(x, w, b):
    """dhg's _conv3_packed: k3 'same' conv of x [B, T, Cin] with w [Co, 3*Cin]
    (column k*Cin + i multiplies x[t + k - 1, i]); the three taps and the bias
    summed in f32, then one rounding to bf16."""
    xp = F.pad(x, (0, 0, 1, 1))
    xcat = torch.cat([xp[:, :-2], xp[:, 1:-1], xp[:, 2:]], dim=-1)
    return (torch.matmul(xcat.float(), w.float().t()) + b.float()).to(BF16)


def conv_block_t4_plain(x, ops: Sequence[torch.Tensor]):
    """dhg's _conv_block_packed: a ConvBlock in bf16 (not conv_block_plain,
    which is dhg's all-f32 conv_block_ref). FiLM multiplies and adds, the fc's
    `+ bias` and `h + skip` each round to bf16."""
    wskip, bskip, w1, b1, w2, b2, wfc, bfc, g1, be1, g2, be2, g3, be3 = ops
    skip = _conv3(x, wskip, bskip)
    h = _conv3(_silu(x), w1, b1) * g1 + be1
    h = _conv3(_silu(h), w2, b2) * g2 + be2
    h = _dense(_silu(h), wfc, bfc) * g3 + be3
    return h + skip


def _avg_pool2(x):
    """Window-2 mean over T, taken in f32 and rounded once."""
    b, t, c = x.shape
    return x.float().reshape(b, t // 2, 2, c).mean(dim=2).to(BF16)


def unet_t4_plain(x, neg, pe4, pe8, att_w, att_b, skip3_w, skip3_b, enc4_ops, enc5_ops,
                  dec3_ops, att_ops, num_layers: int, att_heads: int = 6, enc5_heads: int = 4):
    """dhg's _make_t4_kernel: enc4, enc5, pool, the bottleneck, upsample,
    skip_conv3 and dec3 with the kernel's rounding points."""
    h3 = encoder_layer_plain(conv_block_t4_plain(x, enc4_ops), pe4, neg, enc5_ops, enc5_heads)
    x8 = bottleneck_plain(_avg_pool2(h3), att_w, att_b, pe8, neg, att_ops, num_layers, att_heads)
    xu = torch.repeat_interleave(x8, 2, dim=1)
    return conv_block_t4_plain(xu + _conv3(h3, skip3_w, skip3_b), dec3_ops)


# -- fused_bottleneck's launch shape ----------------------------------------


def _up128(v: int) -> int:
    return (v + 127) // 128 * 128


def bottleneck_layout(t: int, cin: int, d: int, num_heads: int, l: int) -> tuple[int, int]:
    """(shared memory bytes of one CTA, global workspace elements per batch
    row) of csrc/bottleneck.cu (its `layout`). A row that fits is held in
    shared memory with no workspace: the slice Xh, the gathered A [T, D], R
    (attention output + this head's Q/K/V, or the gathered FFN hidden
    [T, 2D], or x_in), Oh, the LayerNorm partial sums and per-row (mu,
    rstd), the ring's mbarriers, 16 bias/FiLM slots of hd, the mask bias
    and the weight ring. A row that does not (T or L over 128, or at
    D = 384 T over 73) spills A, x2 + PE and R to 4 T D elements of
    workspace and keeps Xh, Q = Oh, K and V (128 or 256 rows) and the rest."""
    hd = d // num_heads
    rows = max(t, l)
    tail = (_up128(8 * num_heads * t) + _up128(8 * t) + _up128(16 * 4) + _up128(32 * hd)
            + _up128(2 * l) + RING_BYTES)
    kp = 64 if rows <= 64 else 128
    r = max(2 * t * (d + 8) + 2 * t * (hd + 8) + 4 * kp * (hd + 8),
            2 * t * (2 * d + 8), 2 * t * (cin + 8))
    held = 2 * _up128(2 * t * (hd + 8)) + _up128(2 * t * (d + 8)) + _up128(r) + tail
    if rows <= MAX_HELD and held <= MAX_SMEM:
        return held, 0
    kp = 128 if rows <= 128 else 256
    return 2 * _up128(2 * t * (hd + 8)) + 2 * _up128(2 * kp * (hd + 8)) + tail, 4 * t * d


# Per layer, the operand index (dhg's _PER_LAYER order) of each product in
# the order the kernel runs them: wq, wo, wv2, wq2, wk2, wo2, fc1, fc2.
SCHEDULE = (2, 4, 10, 6, 8, 12, 14, 16)


def _cta_tiles(w, h: int, n: int, depth: int = TILE) -> torch.Tensor:
    """CTA h's rows [h n, (h + 1) n) of a torch Linear weight w [*, K] as
    [chunks x k-tiles, 64, depth] tiles in the order the ring streams them
    (64 output rows a chunk, k outermost within it), zero-padded, each row's
    16-byte chunk c stored at c ^ (row & 7) (the kernels' `load_b_tile`)."""
    sl = w[h * n:(h + 1) * n]
    k = sl.shape[1]
    n_pad, k_pad = -(-n // TILE) * TILE, -(-k // depth) * depth
    sl = F.pad(sl, (0, k_pad - k, 0, n_pad - n))
    t = sl.reshape(n_pad // TILE, TILE, k_pad // depth, depth // 8, 8).permute(0, 2, 1, 3, 4)
    rows = torch.arange(TILE, device=w.device)[:, None] & 7
    idx = (torch.arange(depth // 8, device=w.device)[None, :] ^ rows)[None, None, :, :, None]
    return torch.gather(t, 3, idx.expand(t.shape)).reshape(-1, TILE, depth)


def bottleneck_weights(att_w, layer_ops, num_layers: int) -> list[torch.Tensor]:
    """att_w, then every layer's weights in the kernel's order (SCHEDULE)."""
    return [att_w] + [layer_ops[i * PER_LAYER + j] for i in range(num_layers) for j in SCHEDULE]


def bottleneck_tiles(weights: Sequence[torch.Tensor], num_heads: int) -> torch.Tensor:
    """[num_heads, tiles, 64, 64]: each CTA's slice (its rows / num_heads
    output columns) of every weight in `weights` (bottleneck_weights' order),
    tiled as csrc/bottleneck.cu's ring streams them, one bulk copy a tile."""
    per_cta = [torch.cat([_cta_tiles(w, h, w.shape[0] // num_heads) for w in weights])
               for h in range(num_heads)]
    return torch.stack(per_cta).contiguous()


def bottleneck_refusal(t: int, cin: int, d: int, num_heads: int, l: int) -> str | None:
    """Why csrc/bottleneck.cu cannot take this shape, or None. The grid is
    (num_heads, B) CTAs in clusters of num_heads, one cluster per row."""
    if num_heads > MAX_CLUSTER:
        return f"{num_heads} heads: a row's cluster holds at most {MAX_CLUSTER} CTAs"
    if t > MAX_ROWS or l > MAX_ROWS:
        return f"T = {t}, L = {l}: at most {MAX_ROWS} rows and keys"
    if d // num_heads > 128:
        return f"head dim {d // num_heads} > 128"
    smem = bottleneck_layout(t, cin, d, num_heads, l)[0]
    if smem > MAX_SMEM:
        return (f"T = {t}, D = {d}, {num_heads} heads: a CTA needs {smem} bytes of shared "
                f"memory (at most {MAX_SMEM})")
    return None


# -- fused_encoder_layer's launch shape ---------------------------------------


def _encoder_layer_smem(t: int, tc: int, d: int, num_heads: int) -> int:
    hd = d // num_heads
    kr = max(KEY_CHUNK, -(-t // 16) * 16) if t <= HELD_KEYS else KEY_CHUNK  # keys staged at once
    return (5 * _up128(2 * tc * (d + 8)) + 2 * _up128(2 * kr * (hd + 8))
            + _up128(2 * tc * (kr + 8)) + _up128(8 * ENC_ROWS) + _up128(2 * kr)
            + _up128(2 * 15 * d) + _up128(16 * 2) + 2 * TILE * ENC_TILE_DEPTH * 2)


def encoder_layer_layout(t: int, d: int, num_heads: int) -> tuple[int, int, int]:
    """(CTAs in a row's cluster, rows a CTA, shared memory bytes of a CTA)
    of csrc/encoder_layer.cu (its `layout`): the fewest CTAs of at most 64
    rows whose shared memory fits. A CTA holds X, A, Q, K2 and V2 [Tc, D + 8]
    (fc1's hidden over K2 and V2), one head's staged keys and values [kr,
    hd + 8] (kr: every key of a self-attention up to 256, else 64), its
    logits [Tc, kr + 8], 64 rows' running (max, sum), the staged keys' mask
    bias, 15 D of bias and FiLM, the ring's mbarriers and its two [64, 128]
    tiles. Where none fits: the last layout tried (or one CTA of T rows),
    which encoder_layer_refusal names."""
    tc = t
    for c in range(-(-t // ENC_ROWS), ENC_CLUSTER + 1):
        tc = -(-t // c)
        if _encoder_layer_smem(t, tc, d, num_heads) <= MAX_SMEM:
            break
    return -(-t // tc), tc, _encoder_layer_smem(t, tc, d, num_heads)


def encoder_layer_refusal(t: int, d: int, num_heads: int) -> str | None:
    """Why csrc/encoder_layer.cu cannot take this shape, or None."""
    if num_heads > ENC_HEADS:
        return f"{num_heads} heads: at most {ENC_HEADS}"
    if d // num_heads > ENC_HEAD_DIM:
        return f"head dim {d // num_heads} > {ENC_HEAD_DIM}"
    if d > ENC_WIDTH:
        return f"width {d} > {ENC_WIDTH}"
    c, tc, smem = encoder_layer_layout(t, d, num_heads)
    if tc > ENC_ROWS or c > ENC_CLUSTER or smem > MAX_SMEM:
        return (f"T = {t} at width {d}: a row takes at most {ENC_CLUSTER} CTAs of at most "
                f"{ENC_ROWS} rows within {MAX_SMEM} bytes of shared memory each "
                f"(T <= {ENC_CLUSTER * ENC_ROWS} at width 192)")
    return None


def encoder_layer_tiles(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """[tiles, 64, 128]: one layer's 8 weights in SCHEDULE's order, tiled as
    csrc/encoder_layer.cu's ring streams them: every output column, in
    tiles 128 deep (bottleneck_tiles' layout, twice as deep)."""
    return torch.cat([_cta_tiles(w, 0, w.shape[0], ENC_TILE_DEPTH) for w in weights]).contiguous()


# -- fused_unet_t4's launch shape -----------------------------------------------


def _staged_keys(t: int) -> int:
    """row_layer.cuh's staged_keys: keys of a self-attention staged at once."""
    return max(KEY_CHUNK, -(-t // 16) * 16) if t <= HELD_KEYS else KEY_CHUNK


def _t4_smem(tc: int, kr: int, c2: int, c3: int, d: int, h5: int, h8: int) -> int:
    def conv(cin):  # input and conv1's output with halo rows, skip, conv2's output
        return (_up128(2 * (tc + 2) * (cin + 8)) + 2 * _up128(2 * tc * (c3 + 8))
                + _up128(2 * (tc + 2) * (c3 // 2 + 8)))

    t8 = tc // 2
    union = max(conv(c2), conv(d), 4 * _up128(2 * tc * (c3 + 8)),
                _up128(2 * t8 * (c3 + 8)) + 4 * _up128(2 * t8 * (d + 8)))
    hdm = max(c3 // h5, d // h8) + 8
    return (union + _up128(2 * (tc + 2) * (c3 + 8)) + _up128(2 * t8 * (d + 8))
            + 2 * _up128(2 * kr * hdm) + _up128(2 * tc * (kr + 8)) + _up128(8 * ENC_ROWS)
            + _up128(2 * kr) + _up128(2 * 15 * max(c3, d)) + _up128(16 * 2)
            + 2 * TILE * ENC_TILE_DEPTH * 2)


def t4_layout(t4: int, c2: int, c3: int, d: int, h5: int, h8: int) -> tuple[int, int, int, int]:
    """(CTAs in a row's cluster, T/4 rows a CTA, keys staged at once,
    shared memory bytes of a CTA) of csrc/unet_t4.cu (its `layout`): from
    one CTA up to 8, the first whose even number of rows a CTA (at
    most 64) fits, with every key of enc5's self-attention staged at once
    (up to 256) or, where that does not fit, chunks of 64. A CTA holds the
    union of its stages' buffers (a ConvBlock's input, skip, hidden and conv2
    output; an EncoderLayer's A, Q, K2, V2), h3 with its halo rows, x8, the
    attention's staged keys, values and logits, 64 rows' running (max, sum),
    the mask bias, 15 vectors of the widest layer, the ring's mbarriers and
    its two [64, 128] tiles. Where none fits: the last layout tried, which
    t4_refusal names."""
    held = max(_staged_keys(t4), _staged_keys(t4 // 2))
    shape = (1, t4, held, _t4_smem(t4, held, c2, c3, d, h5, h8))
    for c in range(1, MAX_CLUSTER + 1):
        tc = 2 * -(-(t4 // 2) // c)
        for kr in (held, KEY_CHUNK):
            shape = (-(-t4 // tc), tc, kr, _t4_smem(tc, kr, c2, c3, d, h5, h8))
            if tc <= ENC_ROWS and shape[3] <= MAX_SMEM:
                return shape
    return shape


def t4_refusal(t4: int, c2: int, c3: int, d: int, h5: int, h8: int) -> str | None:
    """Why csrc/unet_t4.cu cannot take this shape, or None."""
    if max(h5, h8) > ENC_HEADS:
        return f"{h5} / {h8} heads: at most {ENC_HEADS}"
    if max(c3 // h5, d // h8) > ENC_HEAD_DIM:
        return f"head dims {c3 // h5} / {d // h8}: at most {ENC_HEAD_DIM}"
    if max(c3, d) > T4_WIDTH:
        return f"widths {c3} / {d}: at most {T4_WIDTH}"
    _, tc, _, smem = t4_layout(t4, c2, c3, d, h5, h8)
    if tc > ENC_ROWS or smem > MAX_SMEM:
        return (f"T4 = {t4}: a row takes at most {MAX_CLUSTER} CTAs of at most {ENC_ROWS} rows "
                f"within {MAX_SMEM} bytes of shared memory each ({smem} needed at {tc} rows)")
    return None


# Per ConvBlock, the operand index (dhg's _PER_CONV order) of each product
# in the kernel's order: conv_skip, conv1, conv2, fc.
CONV_SCHEDULE = (0, 2, 4, 6)


def t4_weights(att_w, skip3_w, enc4_ops, enc5_ops, dec3_ops, att_ops,
               num_layers: int) -> list[torch.Tensor]:
    """Every weight of the region in the order csrc/unet_t4.cu multiplies
    them: enc4's convs and fc, enc5 (SCHEDULE), att_dense, each attention
    layer (SCHEDULE), skip_conv3, dec3's convs and fc. encoder_layer_tiles
    of them is the kernel's tiled copy."""
    return ([enc4_ops[j] for j in CONV_SCHEDULE] + [enc5_ops[j] for j in SCHEDULE] + [att_w]
            + [att_ops[i * PER_LAYER + j] for i in range(num_layers) for j in SCHEDULE]
            + [skip3_w] + [dec3_ops[j] for j in CONV_SCHEDULE])


# -- checks shared by both paths --------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensor(name, t, shape, device):
    # Each condition once; a message is formatted only for the one that fails.
    why = ("expected a tensor" if not isinstance(t, torch.Tensor)
           else f"expected bfloat16, got {t.dtype}" if t.dtype != BF16
           else f"on {t.device}, expected {device}" if t.device != device
           else f"shape {tuple(t.shape)} != {tuple(shape)}" if t.shape != tuple(shape)
           else "must be contiguous" if not t.is_contiguous() else None)
    if why is not None:
        raise ValueError(f"{name}: {why}")


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


def fused_encoder_layer(x, pe, neg, layer_ops: Sequence[torch.Tensor], num_heads: int,
                        tiles: torch.Tensor | None = None):
    """One EncoderLayer.attend: x [B, T, D] bf16 -> [B, T, D] bf16.

    `tiles`: encoder_layer_tiles of these weights (the model passes its
    cached copy), or None to make them here."""
    d = x.shape[-1]
    b, t, l = _check_common(x, pe, neg, d, num_heads)
    why = encoder_layer_refusal(t, d, num_heads)
    _require(why is None, f"fused_encoder_layer: {why}")
    _check_tensor("x", x, (b, t, d), x.device)
    _check_layer(layer_ops, b, t, d, num_heads, l, x.device)
    if x.device.type == "cpu":
        return encoder_layer_plain(x, pe, neg, layer_ops, num_heads)
    operands = [x, pe, neg, *layer_ops]
    _forward_only(operands)
    # cp.async and the 16-byte loads of x, PE and the text K/V.
    _require(all(o.data_ptr() % 16 == 0 for o in operands),
             "fused_encoder_layer: every operand must start on a 16-byte boundary")
    from dhg_torch.kernels.build import check_rc, load

    lib = load()
    if (lib.dhg_encoder_layer_cluster(t, d, num_heads), lib.dhg_encoder_layer_rows(t, d, num_heads),
            lib.dhg_encoder_layer_smem_bytes(t, d, num_heads)) != encoder_layer_layout(t, d, num_heads):
        raise RuntimeError("fused_encoder_layer: encoder_layer_layout disagrees with "
                           "csrc/encoder_layer.cu")
    if tiles is None:
        tiles = encoder_layer_tiles([layer_ops[j] for j in SCHEDULE])
    _check_tensor("tiles", tiles, (tiles.shape[0], TILE, ENC_TILE_DEPTH), x.device)
    out = torch.empty_like(x)
    rc = lib.dhg_fused_encoder_layer(
        x.data_ptr(), pe.data_ptr(), neg.data_ptr(), _ptrs(layer_ops), tiles.data_ptr(),
        tiles.shape[0], out.data_ptr(), b, t, d, num_heads, l,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_rc(lib, rc, "fused_encoder_layer")
    launches["fused_encoder_layer"] += 1
    return out


def fused_bottleneck(x, att_w, att_b, pe, neg, layer_ops: Sequence[torch.Tensor],
                     num_layers: int, num_heads: int = 6, tiles: torch.Tensor | None = None):
    """att_dense + num_layers EncoderLayers: x [B, T8, Cin] -> [B, T8, D] bf16.

    `tiles`: bottleneck_tiles of these weights (the model passes its cached
    copy), or None to make them here. A spilled row (bottleneck_layout) gets
    a workspace of 4 T8 D bf16 a row: its gathered operands do not fit in
    the cluster's shared memory."""
    d, cin = att_w.shape[0], x.shape[-1]
    b, t, l = _check_common(x, pe, neg, d, num_heads)
    _require(cin % 16 == 0, f"x: input width {cin} must be a multiple of 16")
    _require(1 <= num_layers <= MAX_LAYERS, f"num_layers {num_layers} outside [1, {MAX_LAYERS}]")
    why = bottleneck_refusal(t, cin, d, num_heads, l)
    _require(why is None, f"fused_bottleneck: {why}")
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
    operands = [x, att_w, att_b, pe, neg, *layer_ops]
    _forward_only(operands)
    # cp.async and the 16-byte loads of x, the weights and the text K/V.
    _require(all(o.data_ptr() % 16 == 0 for o in operands),
             "fused_bottleneck: every operand must start on a 16-byte boundary")
    from dhg_torch.kernels.build import check_rc, load

    lib = load()
    smem, ws_row = bottleneck_layout(t, cin, d, num_heads, l)
    if (lib.dhg_bottleneck_smem_bytes(t, cin, d, num_heads, l),
            lib.dhg_bottleneck_workspace_elems(t, cin, d, num_heads, l)) != (smem, ws_row):
        raise RuntimeError("fused_bottleneck: bottleneck_layout disagrees with csrc/bottleneck.cu")
    if tiles is None:
        tiles = bottleneck_tiles(bottleneck_weights(att_w, layer_ops, num_layers), num_heads)
    _check_tensor("tiles", tiles, (num_heads, tiles.shape[1], TILE, TILE), x.device)
    ws = torch.empty(b * ws_row, dtype=BF16, device=x.device) if ws_row else None
    out = torch.empty((b, t, d), dtype=BF16, device=x.device)
    ptrs = _ptrs(layer_ops)
    rc = lib.dhg_fused_bottleneck(
        x.data_ptr(), tiles.data_ptr(), tiles.shape[1], att_b.data_ptr(), pe.data_ptr(),
        neg.data_ptr(), ptrs, num_layers, out.data_ptr(), None if ws is None else ws.data_ptr(),
        b, t, cin, d, num_heads, l, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_rc(lib, rc, "fused_bottleneck")
    launches["fused_bottleneck"] += 1
    return out


def _check_conv(ops, cin, co, device, prefix):
    _require(len(ops) == PER_CONV, f"{prefix}expected {PER_CONV} operands, got {len(ops)}")
    c2 = co // 2
    shapes = [(co, 3 * cin), (co,), (c2, 3 * cin), (c2,), (co, 3 * c2), (co,), (co, co), (co,),
              (c2,), (c2,), (co,), (co,), (co,), (co,)]
    names = ["wskip", "bskip", "w1", "b1", "w2", "b2", "wfc", "bfc",
             "g1", "be1", "g2", "be2", "g3", "be3"]
    for name, op, shape in zip(names, ops, shapes):
        _check_tensor(prefix + name, op, shape, device)


def fused_unet_t4(x, neg, pe4, pe8, att_w, att_b, skip3_w, skip3_b,
                  enc4_ops: Sequence[torch.Tensor], enc5_ops: Sequence[torch.Tensor],
                  dec3_ops: Sequence[torch.Tensor], att_ops: Sequence[torch.Tensor],
                  num_layers: int, att_heads: int = 6, enc5_heads: int = 4,
                  tiles: torch.Tensor | None = None):
    """The sampler's whole T/4..T/8 region: x [B, T4, c2] (pooled h2) ->
    dec3's output [B, T4, c3], bf16.

    Operands in dhg's order: neg [B, 1, L]; pe4 [T4, c3] (pos_factor 2);
    pe8 [T4/2, D] (pos_factor 1); att_w [D, c3], att_b [D]; skip3_w
    [D, 3*c3], skip3_b [D]; enc4_ops and dec3_ops, 14 each (conv_skip, conv1,
    conv2 weights as [Co, 3*Cin] rows, column k*Cin + i multiplying
    x[t + k - 1, i], each with its bias; fc [Co, Co] torch Linear layout and
    bias; FiLM gamma/beta [Co/2], [Co], [Co]); enc5_ops, 24 (heads of
    c3/enc5_heads); att_ops, 24 per attention layer (heads of D/att_heads).
    `tiles`: encoder_layer_tiles of t4_weights (the model passes its cached
    copy), or None to make them here. A shape past the kernel's limits
    (t4_refusal) raises on CUDA tensors; CPU tensors take unet_t4_plain at
    every shape.
    """
    _require(x.dim() == 3 and x.device.type in ("cpu", "cuda"),
             f"x: expected [B, T4, C] on cpu or cuda, got {tuple(x.shape)} on {x.device}")
    b, t4, c2 = x.shape
    c3, d = skip3_w.shape[1] // 3, att_w.shape[0]
    _require(t4 % 2 == 0, f"x: T4 = {t4} must be even")
    _require(all(c % 16 == 0 for c in (c2, c3, c3 // 2, d)),
             f"widths {c2}, {c3}, {d} (and {c3 // 2}) must be multiples of 16")
    for width, heads in ((c3, enc5_heads), (d, att_heads)):
        _require(heads > 0 and width % heads == 0 and (width // heads) % 16 == 0,
                 f"width {width} with {heads} heads: head dim must be a multiple of 16")
    _require(1 <= num_layers <= MAX_LAYERS, f"num_layers {num_layers} outside [1, {MAX_LAYERS}]")
    _require(neg.dim() == 3 and neg.shape[1] == 1,
             f"neg: expected [B, 1, L], got {tuple(neg.shape)}")
    l, dev = neg.shape[2], x.device
    for name, t, shape in (("x", x, (b, t4, c2)), ("neg", neg, (b, 1, l)), ("pe4", pe4, (t4, c3)),
                           ("pe8", pe8, (t4 // 2, d)), ("att_w", att_w, (d, c3)),
                           ("att_b", att_b, (d,)), ("skip3_w", skip3_w, (d, 3 * c3)),
                           ("skip3_b", skip3_b, (d,))):
        _check_tensor(name, t, shape, dev)
    _check_conv(enc4_ops, c2, c3, dev, "enc4: ")
    _check_layer(enc5_ops, b, t4, c3, enc5_heads, l, dev, prefix="enc5: ")
    _check_conv(dec3_ops, d, c3, dev, "dec3: ")
    _require(len(att_ops) == num_layers * PER_LAYER,
             f"expected {num_layers * PER_LAYER} attention-layer operands, got {len(att_ops)}")
    for i in range(num_layers):
        _check_layer(att_ops[i * PER_LAYER:(i + 1) * PER_LAYER], b, t4 // 2, d, att_heads, l,
                     dev, prefix=f"layer {i}: ")
    ops = [x, neg, pe4, pe8, att_w, att_b, skip3_w, skip3_b,
           *enc4_ops, *enc5_ops, *dec3_ops, *att_ops]
    if dev.type == "cpu":
        return unet_t4_plain(*ops[:8], enc4_ops, enc5_ops, dec3_ops, att_ops,
                             num_layers, att_heads, enc5_heads)
    why = t4_refusal(t4, c2, c3, d, enc5_heads, att_heads)
    _require(why is None, f"fused_unet_t4: {why}")
    _forward_only(ops)
    # cp.async and the 16-byte loads of x, PE, the vectors and the text K/V.
    _require(all(o.data_ptr() % 16 == 0 for o in ops),
             "fused_unet_t4: every operand must start on a 16-byte boundary")
    from dhg_torch.kernels.build import check_rc, load

    lib = load()
    shape = (t4, c2, c3, d, enc5_heads, att_heads)
    if (lib.dhg_unet_t4_cluster(*shape), lib.dhg_unet_t4_rows(*shape),
            lib.dhg_unet_t4_keys(*shape), lib.dhg_unet_t4_smem_bytes(*shape)) != t4_layout(*shape):
        raise RuntimeError("fused_unet_t4: t4_layout disagrees with csrc/unet_t4.cu")
    if tiles is None:
        tiles = encoder_layer_tiles(t4_weights(att_w, skip3_w, enc4_ops, enc5_ops, dec3_ops,
                                               att_ops, num_layers))
    _check_tensor("tiles", tiles, (lib.dhg_unet_t4_tiles(c2, c3, d, num_layers), TILE,
                                   ENC_TILE_DEPTH), dev)
    out = torch.empty((b, t4, c3), dtype=BF16, device=dev)
    rc = lib.dhg_fused_unet_t4(
        _ptrs(ops), num_layers, tiles.data_ptr(), tiles.shape[0], out.data_ptr(), b, t4, c2, c3,
        d, enc5_heads, att_heads, l, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_rc(lib, rc, "fused_unet_t4")
    launches["fused_unet_t4"] += 1
    return out
