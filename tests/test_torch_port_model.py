"""The port's ops, modules and full forward against dhg in float32, with
dhg's params carried over by the weight bridge: ops and modules within
1e-5, the full DiffusionModel forward within 1e-4 (ARCHITECTURE.md's bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.models.denoiser import DiffusionModel as JaxModel
from dhg.ops import attention as ja
from dhg.ops import basic as jb
from dhg.ops import conv as jc
from dhg_torch.ops import attention as ta
from dhg_torch.ops import basic as tb
from dhg_torch.ops import conv as tc
from test_torch_port_common import f32, inputs, jax_model, port_model, random_params, t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ctx():
    params = random_params(seed=1)
    jm = jax_model()
    pm = port_model(params)
    strokes, text, sigma, style = inputs(batch=2, seq_len=16, text_len=6, seed=2)
    def apply(*a, method=None, **k):
        """dhg's apply as one compiled program: eager flax would compile
        every op on its own."""
        out = jax.jit(lambda p, *x: jm.apply({"params": p}, *x, method=method, **k))(params, *a)
        return jax.block_until_ready(out)

    se = apply(jnp.asarray(sigma), method=JaxModel.embed_sigma)
    cond = apply(jnp.asarray(text), jnp.asarray(style), se, method=JaxModel.encode_cond)
    return dict(params=params, jm=jm, pm=pm, apply=apply, strokes=strokes, text=text,
                sigma=sigma, style=style, se=se, cond=cond)


def test_layer_norm_and_small_ops():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 24).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(f32(tb.layer_norm(t(x))), f32(jb.layer_norm(jnp.asarray(x))), **TOL)
    tokens = np.array([[5, 1, 0, 0], [7, 8, 1, 0]], np.int32)
    np.testing.assert_array_equal(f32(tb.create_padding_mask(t(tokens))),
                                  f32(jb.create_padding_mask(jnp.asarray(tokens))))
    np.testing.assert_array_equal(f32(tb.reshape_up(t(x), 2)), f32(jb.reshape_up(jnp.asarray(x), 2)))
    y = rng.randn(2, 8, 5).astype(np.float32)
    np.testing.assert_allclose(f32(tc.avg_pool_1d(t(y))), f32(jc.avg_pool_1d(jnp.asarray(y))), **TOL)
    np.testing.assert_array_equal(f32(tc.upsample_nearest_1d(t(y))),
                                  f32(jc.upsample_nearest_1d(jnp.asarray(y))))


@pytest.mark.parametrize("length,dim,pf", [(16, 48, 4.0), (50, 96, 1.0), (49, 384, 1.0)])
def test_pos_embeddings(length, dim, pf):
    np.testing.assert_allclose(f32(ta.pos_embeddings(length, dim, pf)),
                               f32(ja.pos_embeddings(length, dim, pf)), **TOL)


def test_sdpa_with_mask():
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 3, 5, 8).astype(np.float32) for _ in range(3))
    mask = np.zeros((2, 1, 1, 5), np.float32)
    mask[1, ..., 3:] = 1.0
    ours = ta.sdpa(t(q), t(k), t(v), t(mask))
    ref = ja._sdpa_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_allclose(f32(ours), f32(ref), **TOL)


def test_conditioning(ctx):
    pm, se = ctx["pm"], ctx["se"]
    with torch.no_grad():
        ose = pm.embed_sigma(t(ctx["sigma"]))
        np.testing.assert_allclose(f32(ose), f32(se), **TOL)
        cond = pm.encode_cond(t(ctx["text"]), t(ctx["style"]), t(se))
    np.testing.assert_allclose(f32(cond), f32(ctx["cond"]), **TOL)


def test_cross_kv_and_films(ctx):
    pm, apply, se, cond = ctx["pm"], ctx["apply"], ctx["se"], ctx["cond"]
    kvs = apply(cond, se, method=JaxModel.precompute_cross_kv)
    films = apply(se, method=JaxModel.precompute_film)
    with torch.no_grad():
        okvs = pm.precompute_cross_kv(t(cond), t(se))
        ofilms = pm.precompute_film(t(se))
    for (k, v), (ok, ov) in zip(kvs, okvs):
        np.testing.assert_allclose(f32(ok), f32(k), **TOL)
        np.testing.assert_allclose(f32(ov), f32(v), **TOL)
    for key in ("conv", "attn"):
        for trip, otrip in zip(films[key], ofilms[key]):
            for (g, b), (og, ob) in zip(trip, otrip):
                np.testing.assert_allclose(f32(og), f32(g), **TOL)
                np.testing.assert_allclose(f32(ob), f32(b), **TOL)


def test_encoder_layer_and_conv_block(ctx):
    """enc3.attend and enc2 ConvBlock alone, on the same inputs."""
    pm, apply, se, cond = ctx["pm"], ctx["apply"], ctx["se"], ctx["cond"]
    rng = np.random.RandomState(3)
    mask = jb.create_padding_mask(jnp.asarray(ctx["text"]))
    x3 = rng.randn(2, 8, 48).astype(np.float32)
    ref = apply(jnp.asarray(x3), cond, se, mask, method=lambda m, x, c, s, k: m.enc3(x, c, s, k))
    x2 = rng.randn(2, 8, 32).astype(np.float32)
    ref2 = apply(jnp.asarray(x2), se, method=lambda m, x, s: m.enc2(x, s))
    with torch.no_grad():
        ours = pm.enc3(t(x3), t(cond), t(se), t(mask))
        ours2 = pm.enc2(t(x2), t(se))
    np.testing.assert_allclose(f32(ours), f32(ref), **TOL)
    np.testing.assert_allclose(f32(ours2), f32(ref2), **TOL)


def test_full_forward_f32(ctx):
    s, tx, sg, st = ctx["strokes"], ctx["text"], ctx["sigma"], ctx["style"]
    eps, pen = ctx["apply"](s, tx, sg, st)
    with torch.no_grad():
        oeps, open_ = ctx["pm"](t(s), t(tx), t(sg), t(st))
    assert oeps.dtype == open_.dtype == torch.float32
    np.testing.assert_allclose(f32(oeps), f32(eps), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(open_), f32(pen), rtol=1e-4, atol=1e-4)


def test_denoise_with_hoisted_context_f32(ctx):
    """denoise(kvs=..., films=...) at batch-1 sigma == dhg's, as the sampler calls it."""
    apply, pm = ctx["apply"], ctx["pm"]
    se1 = apply(jnp.asarray(ctx["sigma"][:1]), method=JaxModel.embed_sigma)
    cond = apply(jnp.asarray(ctx["text"]), jnp.asarray(ctx["style"]), se1,
                 method=JaxModel.encode_cond)
    kvs = apply(cond, se1, method=JaxModel.precompute_cross_kv)
    films = apply(se1, method=JaxModel.precompute_film)
    mask = jb.create_padding_mask(jnp.asarray(ctx["text"]))
    eps, pen = apply(ctx["strokes"], None, None, mask, kvs, films,
                     method=lambda m, x, c, s, k, kv, fi: m.denoise(x, c, s, k, kvs=kv, films=fi))
    with torch.no_grad():
        okvs = pm.precompute_cross_kv(t(cond), t(se1))
        ofilms = pm.precompute_film(t(se1))
        oeps, open_ = pm.denoise(t(ctx["strokes"]), None, None, t(mask), kvs=okvs, films=ofilms)
    np.testing.assert_allclose(f32(oeps), f32(eps), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(open_), f32(pen), rtol=1e-4, atol=1e-4)
