"""Print the CPU margins of the training-path parity tests: how far each
port function is from its dhg counterpart on the tests' own inputs, beside
the bar the test holds it to.

    python tests/torch_port_margins.py

Not a test module (pytest does not collect it); it reuses the helpers of
tests/test_torch_port_{attention_kernel,conv_kernel,train,train_parity}.py.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import test_torch_port_attention_kernel as ta  # noqa: E402
import test_torch_port_conv_kernel as tc  # noqa: E402
import test_torch_port_train as tt  # noqa: E402
import test_torch_port_train_parity as tp  # noqa: E402
from test_torch_port_common import f32, t  # noqa: E402


def attention():
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for tk in (50, 14, 70):
        for masked in (True, False):
            q, k, v, m = ta._inputs(tk, masked)
            for dt in worst:
                ref = ta.pallas_attention(*(jnp.asarray(a, jnp.dtype(dt)) for a in (q, k, v)),
                                          None if m is None else jnp.asarray(m), interpret=True)
                ours = ta.fa.fused_attention(*(t(a, getattr(torch, dt)) for a in (q, k, v)),
                                             None if m is None else t(m))
                worst[dt] = max(worst[dt], float(np.abs(f32(ours) - f32(ref)).max()))
    print(f"attention_plain vs Pallas: f32 {worst['float32']:.2g} (bar 1e-5), "
          f"bf16 {worst['bfloat16']:.2g} (bar 0.05)")
    grad = 0.0
    for masked in (True, False):
        q, k, v, m = ta._inputs(14, masked, seed=1)
        g = np.random.RandomState(2).randn(ta.B, ta.H, ta.TQ, ta.D).astype(np.float32)
        jm = None if m is None else jnp.asarray(m)
        _, vjp = jax.vjp(lambda *a: ta._sdpa_jnp(*a, jm), *(jnp.asarray(a) for a in (q, k, v)))
        leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
        out = ta.fa.FusedAttention.apply(*leaves, None if m is None else t(m))
        got = torch.autograd.grad(out, leaves, t(g))
        grad = max(grad, max(float(np.abs(f32(a) - f32(b)).max())
                             for a, b in zip(got, vjp(jnp.asarray(g)))))
    print(f"FusedAttention grads vs jax.vjp(_sdpa_jnp): {grad:.2g} (bar 1e-4)")


def conv_block():
    worst = 0.0
    for b, tl, cin, co, fb in [(2, 32, 16, 32, None), (1, 48, 32, 64, None), (3, 20, 24, 16, 1)]:
        args = tc._args(b, tl, cin, co, fb)
        ja = [jnp.asarray(a) for a in args[:9]]
        ja += [jnp.broadcast_to(jnp.asarray(a), (b, a.shape[1])) for a in args[9:]]
        ours = tc.fc.fused_conv_block(*(t(a) for a in args))
        worst = max(worst, float(np.abs(f32(ours) - f32(tc.pallas_block(*ja, interpret=True))).max()))
    print(f"conv_block_plain vs Pallas: {worst:.2g} (bar 1e-5 + 1e-5 |ref|)")
    grad = 0.0
    for fb in (None, 1):
        args = tc._args(2, 16, 8, 16, fb, seed=1)
        g = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
        _, vjp = jax.vjp(tc.conv_block_ref, *(jnp.asarray(a) for a in args))
        leaves = [t(a).requires_grad_(True) for a in args]
        got = torch.autograd.grad(tc.fc.ConvBlockFn.apply(*leaves), leaves, t(g))
        grad = max(grad, max(float(np.abs(f32(a) - f32(b)).max())
                             for a, b in zip(got, vjp(jnp.asarray(g)))))
    print(f"ConvBlockFn grads vs jax.vjp(conv_block_ref): {grad:.2g} (bar 1e-5 + 1e-5 |ref|)")


def optimizer():
    types = {"adam": "torch.optim.Adam", "adamw": "torch.optim.AdamW"}
    for kind, mode, clip, lr in [("adam", "norm", 0.5, None), ("adam", "value", 0.3, None),
                                 ("adam", "agc", 0.05, None), ("adamw", "norm", 0.5, None),
                                 ("adam", None, None, 1e-3)]:
        cfg = {"training_args": {"channels": 16, "warmup_steps": 10, "clip_grad": clip,
                                 "clip_mode": mode},
               "optimizer": {"type": types[kind],
                             "params": {"betas": [0.9, 0.98], "weight_decay": 0.01}}}
        model = tt.Tiny()
        opt = tt.make_optimizer(tt.DLConfig(cfg), model, lr_override=lr)
        tx = tt.jax_make_optimizer(tt.JaxConfig(cfg), lr_override=lr)
        params = jax.tree.map(jnp.asarray, tt._to_dhg(dict(model.named_parameters())))
        state = tx.init(params)
        rng = np.random.RandomState(1)
        for _ in range(5):
            grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in model.named_parameters()}
            opt.step([torch.from_numpy(grads[n].copy()) for n in opt.names])
            up, state = tx.update(jax.tree.map(jnp.asarray, tt._to_dhg(grads)), state, params)
            params = optax.apply_updates(params, up)
        gap = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
            jax.tree.leaves(tt._to_dhg(dict(model.named_parameters()))), jax.tree.leaves(params)))
        print(f"optimizer vs optax after 5 updates ({kind}, clip {mode}, lr_override {lr}): "
              f"{gap:.2g} (bar 1e-6)")


def trajectory():
    torch.nn.Dropout.forward = lambda self, x: x  # dropout off, as in the test
    ours, ref = tp.trajectories()
    gap = max(abs(a - b) / abs(b) for a, b in zip(ours, ref))
    print(f"{tp.STEPS}-step f32 loss trajectory vs dhg: {gap:.2g} relative (bar 1e-4)")


if __name__ == "__main__":
    attention()
    conv_block()
    optimizer()
    trajectory()
