"""Scaled-dot-product attention: the wrapper, its plain version, its launch
count, and the autograd.Function the train step uses.

fused_attention
    Replaces dhg/kernels/fused_attention.py::fused_attention:
    softmax(Q K^T * (1/sqrt(D)) + mask * -1e9) V per (batch, head), over
    q [B, H, Tq, D], k/v [B, H, Tk, D] and an optional mask [B, 1, 1, Tk]
    (1.0 = padded key), bfloat16 or float32. On CUDA tensors it runs
    csrc/attention.cu (one block per (b*h, 64 query rows), K/V staged in
    shared memory, f32 FMAs; see the source's note for what bounds it).
attention_plain
    The same function with the kernel's rounding points, in PyTorch: f32
    logits times an f32 scale plus the f32 mask bias, f32 softmax, weights
    rounded to V's type, f32 accumulation of P V, one rounding to Q's type.
    This is NOT dhg's jnp path (which divides in the compute dtype and rounds
    the logits to it): with bf16 inputs the two agree only at the bf16 bar.
FusedAttention
    Forward through fused_attention; backward recomputes the jnp path (the
    port's ops.attention.sdpa_math), as dhg's _sdpa_fused custom_vjp does.
    The mask gets no gradient.

The wrapper takes the plain version only for CPU tensors; a CUDA tensor gets
the kernel or an exception. `launches` counts kernel launches only.
"""

from __future__ import annotations

import numpy as np
import torch

from dhg_torch.kernels.build import MAX_SMEM

launches = {"fused_attention": 0}
DTYPES = (torch.bfloat16, torch.float32)


def reset_launch_count() -> None:
    launches["fused_attention"] = 0


def _scale(depth: int) -> float:
    """1 / sqrt(depth), computed in float32 as the kernels do."""
    return float(np.float32(1.0) / np.sqrt(np.float32(depth)))


def smem_bytes(tk: int, d: int) -> int:
    """Shared memory of one block of csrc/attention.cu (its smem_bytes)."""
    return 4 * (tk * (2 * d + 1) + 8 * (d + tk))


def attention_plain(q, k, v, mask=None):
    """The kernel's math in PyTorch (see the module docstring)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    if mask is not None:
        logits = logits + mask.float() * -1e9
    logits = logits - logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits)
    weights = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def _check(q, k, v, mask):
    def need(cond, msg):
        if not cond:
            raise ValueError(f"fused_attention: {msg}")

    need(q.dim() == 4, f"q: expected [B, H, Tq, D], got {tuple(q.shape)}")
    b, h, _, d = q.shape
    need(q.dtype in DTYPES, f"q: expected bfloat16 or float32, got {q.dtype}")
    need(q.device.type in ("cpu", "cuda"), f"unsupported device {q.device}")
    tk = k.shape[2] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        need(t.dtype == q.dtype, f"{name}: dtype {t.dtype} != q's {q.dtype}")
        need(t.device == q.device, f"{name}: on {t.device}, q on {q.device}")
        need(tuple(t.shape) == (b, h, tk, d), f"{name}: shape {tuple(t.shape)} != {(b, h, tk, d)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        need(t.is_contiguous(), f"{name}: must be contiguous")
    need(tk >= 1, "k: no keys")
    need(smem_bytes(tk, d) <= MAX_SMEM,
         f"Tk = {tk}, D = {d}: K and V need {smem_bytes(tk, d)} bytes of shared memory")
    if mask is not None:
        need(mask.device == q.device, f"mask: on {mask.device}, q on {q.device}")
        need(tuple(mask.shape) == (b, 1, 1, tk), f"mask: shape {tuple(mask.shape)} != {(b, 1, 1, tk)}")


def fused_attention(q, k, v, mask=None):
    """softmax(q k^T / sqrt(D) + mask * -1e9) v -> [B, H, Tq, D] in q's dtype."""
    _check(q, k, v, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("fused_attention is forward-only; use FusedAttention.apply for gradients")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    from dhg_torch.kernels.build import check_rc, load

    lib = load()
    b, h, tq, d = q.shape
    tk = k.shape[2]
    m = None if mask is None else mask.reshape(b, tk).float().contiguous()
    out = torch.empty_like(q)
    rc = lib.dhg_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if m is None else m.data_ptr(),
        out.data_ptr(), b, h, tq, tk, d, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_rc(lib, rc, "fused_attention")
    launches["fused_attention"] += 1
    return out


class FusedAttention(torch.autograd.Function):
    """Kernel forward; backward through the plain jnp-path math."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return fused_attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, grad):
        from dhg_torch.ops.attention import sdpa_math

        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = sdpa_math(*leaves, mask)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None
