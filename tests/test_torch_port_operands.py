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
