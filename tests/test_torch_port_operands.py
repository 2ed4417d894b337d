"""Random bf16 operands for the port's attention kernels, in both layouts.

numpy and torch only (no JAX), so the CUDA tests can use it on a machine
without JAX. Helpers only: it defines no tests.
"""

from __future__ import annotations

import numpy as np
import torch


def kernel_operands(rng, b, t_len, d, heads, l, cin=None, n_layers=1, device="cpu"):
    """Operands of fused_encoder_layer (cin None) or fused_bottleneck.

    Returns (arrays, tensors): float32 numpy arrays in dhg's layout (Dense
    kernels [in, out], FiLM [1, D]) and the port's bf16 tensors (Linear
    weights [out, in], FiLM [D]) holding the same values once rounded.
    Keys: x, pe, neg, aw, ab, ops (24 per layer, dhg's _PER_LAYER order).
    """
    hd = d // heads

    def w(n_in, n_out):  # torch layout [out, in]
        return rng.uniform(-1, 1, (n_out, n_in)).astype(np.float32) / np.sqrt(n_in)

    def vec(n, base=0.0, scale=0.1):
        return (base + scale * rng.randn(n)).astype(np.float32)

    tokens = rng.randint(2, 73, (b, l))
    for i in range(b):  # a few padded keys per row, one row fully open
        tokens[i, l - i % 3:] = 0
    neg = ((tokens == 0).astype(np.float32) * -1e9)[:, None, :]
    x = rng.randn(b, t_len, cin or d).astype(np.float32)
    pe = rng.randn(t_len, d).astype(np.float32)
    layers = []
    for _ in range(n_layers):
        ops = [rng.randn(b, heads, l, hd).astype(np.float32) for _ in range(2)]
        for _ in range(6):
            ops += [w(d, d), vec(d)]
        ops += [w(d, 2 * d), vec(2 * d), w(2 * d, d), vec(d)]
        for _ in range(3):
            ops += [vec(d, 1.0), vec(d)]
        layers.append(ops)
    aw, ab = w(cin or d, d), vec(d)

    def dhg_layout(ops):
        out = []
        for i, a in enumerate(ops):
            out.append(a.T if a.ndim == 2 else (a[None] if i >= 18 else a))
        return out

    def tt(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=torch.bfloat16)

    arrays = dict(x=x, pe=pe, neg=neg, aw=aw.T, ab=ab,
                  ops=[a for o in layers for a in dhg_layout(o)])
    tensors = dict(x=tt(x), pe=tt(pe), neg=tt(neg), aw=tt(aw), ab=tt(ab),
                   ops=[tt(a) for o in layers for a in o])
    return arrays, tensors


def t4_operands(rng, b, t4, c2, c3, d, h5, h8, l, n_layers, device="cpu"):
    """Operands of fused_unet_t4, as (arrays, tensors) in the two layouts:
    dhg's (conv kernels [3, Cin, Co], Dense [in, out], FiLM [1, C]) and the
    port's bf16 ones (conv rows [Co, 3*Cin], Linear [out, in], FiLM [C]).
    Keys: x, neg, pe4, pe8, aw, ab, sk3w, sk3b (dhg's order), then the lists
    enc4, enc5, dec3, att."""
    e5, e5_t = kernel_operands(rng, b, t4, c3, h5, l, device=device)
    bn, bn_t = kernel_operands(rng, b, t4 // 2, d, h8, l, cin=c3, n_layers=n_layers, device=device)

    def tt(a):
        a = np.ascontiguousarray(a, dtype=np.float32)
        return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)

    def conv(cin, co):  # dhg layout [3, cin, co] and the port's rows [co, 3 * cin]
        k = rng.uniform(-1, 1, (3, cin, co)).astype(np.float32) / np.sqrt(3 * cin)
        return k, k.reshape(3 * cin, co).T

    def vec(n, base=0.0):
        return (base + 0.1 * rng.randn(n)).astype(np.float32)

    def block(cin, co):
        ch = co // 2
        arr, ten = [], []
        for ci, c in ((cin, co), (cin, ch), (ch, co)):
            k, rows = conv(ci, c)
            bias = vec(c)
            arr += [k, bias]
            ten += [rows, bias]
        fc = rng.uniform(-1, 1, (co, co)).astype(np.float32) / np.sqrt(co)
        bias = vec(co)
        arr += [fc.T, bias]
        ten += [fc, bias]
        for c in (ch, co, co):
            g, be = vec(c, 1.0), vec(c)
            arr += [g[None], be[None]]
            ten += [g, be]
        return arr, [tt(a) for a in ten]

    x = rng.randn(b, t4, c2).astype(np.float32)
    sk3, sk3_rows = conv(c3, d)
    sk3b = vec(d)
    enc4, enc4_t = block(c2, c3)
    dec3, dec3_t = block(d, c3)
    arrays = dict(x=x, neg=e5["neg"], pe4=e5["pe"], pe8=bn["pe"], aw=bn["aw"], ab=bn["ab"],
                  sk3w=sk3, sk3b=sk3b, enc4=enc4, enc5=e5["ops"], dec3=dec3, att=bn["ops"])
    tensors = dict(x=tt(x), neg=e5_t["neg"], pe4=e5_t["pe"], pe8=bn_t["pe"], aw=bn_t["aw"],
                   ab=bn_t["ab"], sk3w=tt(sk3_rows), sk3b=tt(sk3b), enc4=enc4_t,
                   enc5=e5_t["ops"], dec3=dec3_t, att=bn_t["ops"])
    return arrays, tensors
