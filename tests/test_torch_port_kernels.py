"""The port's attention kernels.

On the CPU: each kernel's plain PyTorch version against dhg's Pallas kernel
in interpret mode on the same bf16 operands, and a bf16 denoise with
hoisted kvs/films against dhg's, at the bf16 bar of
tests/test_fused_bottleneck.py (rtol = atol = 0.05, median |diff| < 5e-3).

The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.kernels import fused_bottleneck as jk
from dhg.ops.basic import create_padding_mask as jmask
from dhg_torch.kernels import fused_bottleneck as tk
from dhg_torch.ops.basic import create_padding_mask
from test_torch_port_common import assert_bf16_close, inputs, jax_model, port_model, random_params, t
from test_torch_port_operands import kernel_operands

BF = torch.bfloat16


def _operands(rng, *shape, **kw):
    """(jax bf16 operands in dhg's layout, the port's bf16 tensors)."""
    arrays, tensors = kernel_operands(rng, *shape, **kw)

    def jx(a):
        return jnp.asarray(a, jnp.bfloat16)

    j = {k: (tuple(jx(a) for a in v) if k == "ops" else jx(v)) for k, v in arrays.items()}
    return j, tensors


@pytest.mark.parametrize("b,t_len,d,heads,l", [(8, 24, 48, 3, 7), (8, 12, 64, 4, 9), (2, 8, 128, 2, 5)])
def test_encoder_layer_plain_matches_pallas(b, t_len, d, heads, l):
    j, o = _operands(np.random.RandomState(d), b, t_len, d, heads, l)
    ref = jk.fused_encoder_layer(j["x"], j["pe"], j["neg"], j["ops"], num_heads=heads,
                                 rows=1, interpret=True)
    before = dict(tk.launches)
    ours = tk.fused_encoder_layer(o["x"], o["pe"], o["neg"], o["ops"], heads)
    assert tk.launches == before  # the CPU path launches no kernel
    assert ours.dtype == BF and ours.shape == (b, t_len, d)
    assert_bf16_close(ours, ref)


@pytest.mark.parametrize("b,n_layers", [(3, 2), (1, 1)])
def test_bottleneck_plain_matches_pallas(b, n_layers):
    j, o = _operands(np.random.RandomState(b), b, 6, 96, 6, 7, cin=64, n_layers=n_layers)
    ref = jk.fused_bottleneck(j["x"], j["aw"], j["ab"], j["pe"], j["neg"], j["ops"],
                              num_layers=n_layers, num_heads=6, rows=1, interpret=True)
    before = dict(tk.launches)
    ours = tk.fused_bottleneck(o["x"], o["aw"], o["ab"], o["pe"], o["neg"], o["ops"],
                               n_layers, 6)
    assert tk.launches == before
    assert_bf16_close(ours, ref)


def test_wrappers_reject_bad_operands():
    _, o = _operands(np.random.RandomState(0), 2, 8, 48, 3, 5)
    with pytest.raises(ValueError, match="bfloat16"):
        tk.fused_encoder_layer(o["x"].float(), o["pe"], o["neg"], o["ops"], 3)
    with pytest.raises(ValueError, match="contiguous"):
        bad = o["x"].transpose(0, 1).contiguous().transpose(0, 1)
        tk.fused_encoder_layer(bad, o["pe"], o["neg"], o["ops"], 3)
    with pytest.raises(ValueError, match="operands"):
        tk.fused_encoder_layer(o["x"], o["pe"], o["neg"], o["ops"][:-1], 3)
    with pytest.raises(ValueError, match="multiples of 16"):
        tk.fused_encoder_layer(o["x"], o["pe"], o["neg"], o["ops"], 6)


def _hoisted_denoise(m, s, tx, sg, st):
    """dhg's denoise with the sampler's hoisted kvs/films."""
    se = m.embed_sigma(sg[:1])
    cond = m.encode_cond(tx, st, se)
    kvs, films = m.precompute_cross_kv(cond, se), m.precompute_film(se)
    return m.denoise(s, None, None, jmask(tx), kvs=kvs, films=films)


@pytest.fixture(scope="module")
def bf16_ctx():
    """(params, dhg's hoisted denoise as one compiled program, the port's
    model). Eager flax would compile every op on its own: tens of seconds."""
    params = random_params(seed=4)
    jm = jax_model(jnp.bfloat16)
    run = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=_hoisted_denoise))
    return params, run, port_model(params, BF)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_bf16_denoise_matches_dhg(bf16_ctx, monkeypatch, fused):
    """Batch 9 takes both kernels' plain versions when forced on ("1"), the
    plain module path when off ("0"); both match dhg's bf16 denoise. (9 is
    inside the 8 <= B <= 128 gate and gives dhg's Pallas kernels rows=1,
    which interpret mode runs far faster than rows=8.)"""
    params, jax_denoise, pm = bf16_ctx
    monkeypatch.setenv("DHG_FUSED_BOTTLENECK", fused)
    strokes, text, sigma, style = inputs(batch=9, seq_len=24, text_len=6, seed=5)
    eps, pen = jax.block_until_ready(jax_denoise(params, strokes, text, sigma, style))
    with torch.no_grad():
        tx = t(text)
        se = pm.embed_sigma(t(sigma[:1]))
        cond = pm.encode_cond(tx, t(style), se)
        kvs, films = pm.precompute_cross_kv(cond, se), pm.precompute_film(se)
        assert pm._can_fuse_bottleneck(kvs, films, torch.device("cpu")) == (fused == "1")
        before = dict(tk.launches)
        oeps, open_ = pm.denoise(t(strokes), None, None, create_padding_mask(tx),
                                 kvs=kvs, films=films)
        assert tk.launches == before
    assert oeps.dtype == torch.float32
    assert_bf16_close(oeps, eps)
    assert_bf16_close(open_, pen)
