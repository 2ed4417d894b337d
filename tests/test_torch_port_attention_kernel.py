"""The port's attention kernel path on the CPU.

attention_plain (the CUDA kernel's plain version) against dhg's Pallas
kernel in interpret mode, in f32 at 1e-5 and in bf16 at the bf16 bar;
FusedAttention's gradients against jax.vjp(_sdpa_jnp) at 1e-4 (the bar of
tests/test_kernels.py); the DHG_FUSED_ATTENTION route and the wrapper's
checks. The kernel itself is held to attention_plain on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.kernels.fused_attention import fused_attention as pallas_attention
from dhg.ops.attention import _sdpa_jnp
from dhg_torch.kernels import fused_attention as fa
from dhg_torch.ops.attention import MultiHeadAttention, sdpa, sdpa_math
from test_torch_port_common import assert_bf16_close, f32, t

B, H, TQ, D = 2, 3, 8, 16


def _inputs(tk, masked, seed=0):
    """q, k, v (f32 numpy) and a [B, 1, 1, Tk] mask with a padded tail per
    row (at least one open key), or None."""
    rng = np.random.RandomState(seed + tk)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32) for n in (TQ, tk, tk))
    mask = None
    if masked:
        mask = np.zeros((B, 1, 1, tk), np.float32)
        for i in range(B):
            mask[i, ..., max(1, tk - 3 - 5 * i):] = 1.0
    return q, k, v, mask


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("tk", [50, 14, 70])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas(dtype, tk, masked):
    q, k, v, mask = _inputs(tk, masked)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = pallas_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                           None if mask is None else jnp.asarray(mask), interpret=True)
    before = fa.launches["fused_attention"]
    ours = fa.fused_attention(*(t(a, tdt) for a in (q, k, v)), None if mask is None else t(mask))
    assert fa.launches["fused_attention"] == before  # the CPU path launches nothing
    assert ours.dtype == tdt and ours.shape == (B, H, TQ, D)
    if dtype == "float32":
        np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5, atol=1e-5)
    else:
        assert_bf16_close(ours, ref)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
def test_fused_attention_gradients_match_sdpa_jnp(masked):
    q, k, v, mask = _inputs(14, masked, seed=1)
    g = np.random.RandomState(2).randn(B, H, TQ, D).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: _sdpa_jnp(*a, jmask), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))

    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.FusedAttention.apply(*leaves, None if mask is None else t(mask))
    got = torch.autograd.grad(out, leaves, t(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-4)


def test_sdpa_routes_through_the_kernel_path(monkeypatch):
    q, k, v, mask = (None if a is None else t(a) for a in _inputs(14, True, seed=3))
    monkeypatch.setenv("DHG_FUSED_ATTENTION", "0")
    torch.testing.assert_close(sdpa(q, k, v, mask), sdpa_math(q, k, v, mask))
    monkeypatch.setenv("DHG_FUSED_ATTENTION", "1")
    torch.testing.assert_close(sdpa(q, k, v, mask), fa.attention_plain(q, k, v, mask))
    # Through a module, with gradients reaching its weights.
    mha = MultiHeadAttention(24, 3)
    x = torch.randn(2, 5, 24)
    out = mha(x, x, x)
    out.sum().backward()
    assert out.grad_fn is not None and mha.wq.weight.grad is not None
    monkeypatch.setenv("DHG_FUSED_ATTENTION", "0")
    torch.testing.assert_close(mha(x, x, x), out.detach(), rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = (None if a is None else t(a) for a in _inputs(14, True, seed=4))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.fused_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        fa.fused_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="mask: shape"):
        fa.fused_attention(q, k, v, mask[:, :, :, :-1])
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 1, 1000, 64)
        fa.fused_attention(big[:, :, :1].contiguous(), big, big)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.fused_attention(q.requires_grad_(True), k, v)
