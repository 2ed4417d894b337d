"""The port's fused ConvBlock path on the CPU.

conv_block_plain (the CUDA kernel's plain version) against dhg's Pallas
kernel in interpret mode and its conv_block_ref at 1e-5 (the bar of
tests/test_fused_conv_block.py), a batch-1 FiLM included; ConvBlockFn's
gradients for x, every weight and the FiLM coefficients against
jax.vjp(conv_block_ref); the DHG_FUSED_CONVBLOCK route of the port's
ConvBlock against its unfused f32 path; the wrapper's checks. The kernel
itself is held to conv_block_plain on the card by tests/test_torch_port_cuda.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.kernels.fused_conv_block import conv_block_ref, fused_conv_block as pallas_block
from dhg_torch.kernels import fused_conv_block as fc
from dhg_torch.ops.conv import ConvBlock
from test_torch_port_common import f32, t


def _args(b, t_len, cin, co, film_batch=None, seed=0):
    """dhg's operand list as f32 numpy: x, 8 weights in dhg's layout, 6 FiLM."""
    rng = np.random.RandomState(seed)
    c2, fb = co // 2, film_batch or b

    def r(*shape, scale=0.2, base=0.0):
        return (base + scale * rng.randn(*shape)).astype(np.float32)

    return [r(b, t_len, cin, scale=1.0),
            r(3, cin, co), r(co, scale=0.1), r(3, cin, c2), r(c2, scale=0.1),
            r(3, c2, co), r(co, scale=0.1), r(co, co), r(co, scale=0.1),
            r(fb, c2, scale=0.1, base=1.0), r(fb, c2, scale=0.1),
            r(fb, co, scale=0.1, base=1.0), r(fb, co, scale=0.1),
            r(fb, co, scale=0.1, base=1.0), r(fb, co, scale=0.1)]


@pytest.mark.parametrize("b,t_len,cin,co,film_batch", [(2, 32, 16, 32, None), (1, 48, 32, 64, None),
                                                       (3, 20, 24, 16, 1)])
def test_conv_block_plain_matches_pallas_and_ref(b, t_len, cin, co, film_batch):
    args = _args(b, t_len, cin, co, film_batch)
    # dhg's kernel reads per-row FiLM: give it the batch-1 rows broadcast.
    jargs = [jnp.asarray(a) for a in args[:9]]
    jargs += [jnp.broadcast_to(jnp.asarray(a), (b, a.shape[1])) for a in args[9:]]
    kernel = pallas_block(*jargs, interpret=True)
    ref = conv_block_ref(*jargs)
    before = fc.launches["fused_conv_block"]
    ours = fc.fused_conv_block(*(t(a) for a in args))
    assert fc.launches["fused_conv_block"] == before
    assert ours.shape == (b, t_len, co)
    np.testing.assert_allclose(f32(ours), f32(kernel), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("film_batch", [None, 1], ids=["film_b", "film_1"])
def test_conv_block_fn_gradients_match_jax_vjp(film_batch):
    args = _args(2, 16, 8, 16, film_batch, seed=1)
    g = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    _, vjp = jax.vjp(conv_block_ref, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))

    leaves = [t(a).requires_grad_(True) for a in args]
    got = torch.autograd.grad(fc.ConvBlockFn.apply(*leaves), leaves, t(g))
    for name, a, b in zip(("x",) + fc.NAMES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5, err_msg=name)


def test_bf16_input_rounds_once_at_the_output():
    args = _args(2, 12, 8, 16, seed=3)
    x = t(args[0], torch.bfloat16)
    ours = fc.fused_conv_block(x, *(t(a) for a in args[1:]))
    ref = conv_block_ref(jnp.asarray(args[0], jnp.bfloat16), *(jnp.asarray(a) for a in args[1:]))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(ours), f32(ref))


@pytest.mark.parametrize("film", ["per_row", "batch1"])
def test_routed_conv_block_matches_unfused(monkeypatch, film):
    """DHG_FUSED_CONVBLOCK=1 on the CPU runs ConvBlockFn (the plain version):
    same output and gradients as the unfused f32 module path."""
    torch.manual_seed(0)
    block = ConvBlock(12, 16, 8).train()  # dropout 0: the gate holds in training
    x = torch.randn(3, 10, 12, requires_grad=True)
    sigma_emb = torch.randn(1 if film == "batch1" else 3, 8)

    def run(flag):
        monkeypatch.setenv("DHG_FUSED_CONVBLOCK", flag)
        block.zero_grad()
        x.grad = None
        out = block(x, sigma_emb)
        out.square().sum().backward()
        grads = [x.grad.clone()] + [p.grad.clone() for p in block.parameters()]
        return out.detach(), grads

    out1, g1 = run("1")
    out0, g0 = run("0")
    torch.testing.assert_close(out1, out0, rtol=1e-5, atol=1e-5)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_gate_stays_off_under_live_dropout(monkeypatch):
    monkeypatch.setenv("DHG_FUSED_CONVBLOCK", "1")
    block = ConvBlock(8, 16, 8, drop_rate=0.5).train()
    calls = []
    monkeypatch.setattr(fc.ConvBlockFn, "apply", lambda *a: calls.append(1))
    block(torch.randn(2, 8, 8), torch.randn(2, 8))
    assert not calls
    block.eval()
    block(torch.randn(2, 8, 8), torch.randn(2, 8))
    assert calls == [1]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = [t(a) for a in _args(2, 8, 8, 16)]
    x, ops = args[0], args[1:]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fc.fused_conv_block(x.half(), *ops)
    with pytest.raises(ValueError, match="operands"):
        fc.fused_conv_block(x, *ops[:-1])
    with pytest.raises(ValueError, match="w1: shape"):
        fc.fused_conv_block(x, ops[0], ops[1], ops[2][:, :-1], *ops[3:])
    with pytest.raises(ValueError, match="g2: shape"):
        fc.fused_conv_block(x, *ops[:10], ops[10][:1].expand(3, -1), *ops[11:])
    with pytest.raises(ValueError, match="float32"):
        fc.fused_conv_block(x, *ops[:-1], ops[-1].to(torch.bfloat16))
    with pytest.raises(ValueError, match="8 \\| Co"):
        fc.fused_conv_block(torch.zeros(1, 4, 8), *[torch.zeros(3, 8, 12)] + ops[1:])
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.fused_conv_block(x.requires_grad_(True), *ops)
