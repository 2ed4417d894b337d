"""Print the CPU margins of the port's parity tests: how far each port
function is from its dhg counterpart on the tests' own inputs, beside the
bar the test holds it to.

    python tests/torch_port_margins.py [section ...]

Sections: encoder_layer (the sampler's enc3/enc5 kernel), attention,
conv_block, optimizer, trajectory (the training path), t4, front_end (the
T4 region and the infer front end), serve (the serving slice's sampler
against dhg's per-request keys, and one served group against dhg's
service); all by default.
Not a test module (pytest does not collect it); it reuses the helpers of
the tests/test_torch_port_*.py files it names.
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


def encoder_layer():
    import test_torch_port_kernels as tkt

    for b, tl, d, heads, l in [(8, 24, 48, 3, 7), (8, 12, 64, 4, 9), (2, 8, 128, 2, 5)]:
        j, o = tkt._operands(np.random.RandomState(d), b, tl, d, heads, l)
        ref = tkt.jk.fused_encoder_layer(j["x"], j["pe"], j["neg"], j["ops"], num_heads=heads,
                                         rows=1, interpret=True)
        ours = tkt.tk.fused_encoder_layer(o["x"], o["pe"], o["neg"], o["ops"], heads)
        diff = np.abs(f32(ours) - f32(ref))
        print(f"encoder_layer_plain vs Pallas ({b}x{tl}x{d}, {heads} heads): max "
              f"{diff.max():.3g}, median {np.median(diff):.3g} (bar 0.05 + 0.05 |ref|, median 5e-3)")


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


def t4():
    import test_torch_port_t4 as t4t

    for n in (1, 2):
        j, o = t4t._operands(n, seed=n)
        ref = t4t.jk.fused_unet_t4(*t4t._args(j), num_layers=n, att_heads=6, enc5_heads=4,
                                   rows=1, interpret=True)
        d = np.abs(f32(t4t.tk.fused_unet_t4(*t4t._args(o), n, 6, 4)) - f32(ref))
        print(f"unet_t4_plain vs Pallas ({n} layers): max {d.max():.3g}, median "
              f"{np.median(d):.3g} (bar 0.05 + 0.05 |ref|, median 5e-3)")
    params = t4t.random_params(seed=9)
    jm, pm = t4t.jax_model(jnp.bfloat16), t4t.port_model(params, t4t.BF)
    strokes, text, sigma, style = t4t.inputs(batch=3, seq_len=48, text_len=6, seed=12)

    def run(m, s, tx, sg, st):
        se = m.embed_sigma(sg[:1])
        cond = m.encode_cond(tx, st, se)
        kvs, films = m.precompute_cross_kv(cond, se), m.precompute_film(se)
        return m._denoise_fused_t4(s, t4t.jmask(tx), kvs, films)

    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=run))(
        params, strokes, text, sigma, style)
    os.environ["DHG_FUSED_T4"] = "1"
    with torch.no_grad():
        kvs, films, mask = t4t._port_context(pm, text, sigma, style)
        ours = pm.denoise(t(strokes), None, None, mask, kvs=kvs, films=films)
    del os.environ["DHG_FUSED_T4"]
    for name, a, b in zip(("eps", "pen"), ours, ref):
        d = np.abs(f32(a) - f32(b))
        print(f"T4 denoise vs dhg's _denoise_fused_t4, {name}: max {d.max():.3g}, "
              f"median {np.median(d):.3g} (same bar)")


def front_end():
    import tempfile
    from pathlib import Path

    import cv2
    import flax

    import test_torch_port_style as ts
    from dhg.data.images import read_img as jax_read_img
    from dhg_torch.data.images import read_img

    with tempfile.TemporaryDirectory() as tmp:
        worst = 0
        for seed in range(4):
            rng = np.random.RandomState(seed)
            img = ts._line_image(rng, 60 + 20 * seed, 230 + 150 * seed)
            path = str(Path(tmp) / "s.png")
            cv2.imwrite(path, img)
            for h in (96, 40):
                worst = max(worst, int(np.abs(read_img(path, h).astype(int)
                                              - jax_read_img(path, h).astype(int)).max()))
        print(f"read_img vs dhg (cv2): max {worst} grey levels (bar 1)")
    with np.load(ts.SYNTH) as f:
        flat = dict(f)
    variables = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    img = np.random.RandomState(3).uniform(0, 255, (2, 96, 192)).astype(np.float32)
    ref = np.asarray(jax.jit(ts.JaxStyleExtractor().apply)(variables, img))
    with torch.no_grad():
        ours = ts.init_style_extractor(ts.SYNTH, device="cpu")(torch.from_numpy(img)).numpy()
    print(f"StyleExtractor vs dhg: max {np.abs(ours - ref).max():.3g} "
          f"(bar 1e-4; largest |value| {np.abs(ref).max():.3g})")


def serve():
    import test_torch_port_serve as tsv

    params = tsv.random_params(seed=0, c1=tsv.C1, num_layers=tsv.N_LAYERS)
    for variant in tsv.SLICE_VARIANTS:
        ours, ref = tsv.slice_against_dhg(params, variant)
        print(f"serve slice ({variant}, B = 3) vs dhg's generate(sample_keys): stroke MSE "
              f"{float(np.mean((ours - ref) ** 2)):.2g} (bar 1e-3)")
    ours, ref, _ = tsv.served_group_against_dhg(params)
    diff = np.concatenate([o - r for o, r in zip(ours, ref)])
    print(f"serve group (3 requests padded to 4) vs dhg's GenerationService: stroke MSE "
          f"{float(np.mean(diff ** 2)):.2g} (bar 1e-3)")


if __name__ == "__main__":
    sections = dict(encoder_layer=encoder_layer, attention=attention, conv_block=conv_block,
                    optimizer=optimizer,
                    trajectory=trajectory, t4=t4, front_end=front_end, serve=serve)
    for name in sys.argv[1:] or sections:
        sections[name]()
