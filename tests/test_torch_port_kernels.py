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


def test_bottleneck_launch_shape():
    """csrc/bottleneck.cu's per-CTA shared memory (one row per cluster of
    num_heads CTAs): 167,040 bytes and no workspace at the canonical shape;
    at D = 384 rows are held up to T8 = 73 (36-token prompts), longer ones
    spill 4 T8 D elements a row (T8 = 101 for a 50-token prompt) up to
    T8 = 256; 3 and 8 heads fit."""
    assert tk.bottleneck_layout(49, 256, 384, 6, 50) == (167040, 0)
    for heads in (3, 6, 8):
        assert tk.bottleneck_refusal(49, 256, 384, heads, 50) is None
    assert tk.bottleneck_layout(73, 256, 384, 6, 50)[1] == 0
    assert tk.bottleneck_layout(74, 256, 384, 6, 50)[1] == 4 * 74 * 384
    assert tk.bottleneck_layout(101, 256, 384, 6, 50) == (106880, 4 * 101 * 384)
    assert tk.bottleneck_layout(256, 256, 384, 6, 50) == (196864, 4 * 256 * 384)
    assert tk.bottleneck_layout(20, 64, 96, 6, 129)[1] == 4 * 20 * 96  # keys over 128
    for t8 in (74, 101, 256):
        assert tk.bottleneck_refusal(t8, 256, 384, 6, 50) is None
    assert "at most 8" in tk.bottleneck_refusal(49, 256, 576, 9, 50)
    assert "rows and keys" in tk.bottleneck_refusal(257, 256, 384, 6, 50)
    assert "rows and keys" in tk.bottleneck_refusal(20, 64, 96, 6, 257)
    assert "shared memory" in tk.bottleneck_refusal(256, 256, 768, 6, 50)  # hd 128


def test_bottleneck_tiles_follow_the_kernel_addressing():
    """bottleneck_tiles lays each CTA's weight slices out in the order the
    kernel's ring streams them; reading each tile with load_b_tile's
    swizzled address (chunk c of row n at c ^ (n & 7)) gives the slice back,
    zero-padded to whole [64, 64] tiles."""
    b, t_len, cin, d, heads, l = 1, 6, 80, 96, 6, 7
    _, o = _operands(np.random.RandomState(2), b, t_len, d, heads, l, cin=cin, n_layers=2)
    weights = tk.bottleneck_weights(o["aw"], o["ops"], 2)
    tiles = tk.bottleneck_tiles(weights, heads)
    n = torch.arange(64)[:, None]
    k = torch.arange(64)[None, :]
    phys = ((k // 8) ^ (n & 7)) * 8 + k % 8
    assert all(w is o["ops"][i * 24 + j]
               for w, (i, j) in zip(weights[1:], [(i, j) for i in range(2) for j in tk.SCHEDULE]))
    for h in (0, heads - 1):
        cursor = 0
        for w in weights:
            rows = w.shape[0] // heads
            sl = w[h * rows:(h + 1) * rows].float()
            kk = sl.shape[1]
            for c0 in range(0, rows, 64):
                for k0 in range(0, kk, 64):
                    got = tiles[h, cursor].float().gather(1, phys)
                    want = torch.zeros(64, 64)
                    part = sl[c0:c0 + 64, k0:k0 + 64]
                    want[:part.shape[0], :part.shape[1]] = part
                    assert torch.equal(got, want)
                    cursor += 1
        assert cursor == tiles.shape[1]
    # 124 tiles a CTA at the canonical shape: att_dense 4, per layer 6 x 6 + 12 + 12.
    canonical = [torch.zeros(384, 256)] + [torch.zeros(384, 384)] * 6
    canonical += [torch.zeros(768, 384), torch.zeros(384, 768)]
    assert tk.bottleneck_tiles(canonical[:1] + canonical[1:] * 2, 6).shape == (6, 124, 64, 64)


def test_model_bottleneck_tiles_are_cached_per_weight_set():
    """DiffusionModel.bottleneck_tiles tiles the bf16 copies of att_dense and
    every attention layer's Dense weights in the kernel's order, once per
    weight set: the same tensor again, a new one after a weight changes."""
    from dhg_torch.models.denoiser import DiffusionModel

    m = DiffusionModel(num_layers=2, c1=32, c2=48, c3=64, dtype=BF).eval()
    with torch.no_grad():
        tiles = m.bottleneck_tiles()
        assert m.bottleneck_tiles() is tiles
        ops = []
        for layer in m.att_layers:
            ops += [None, None]
            for lin in (layer.mha.wq, layer.mha.dense, layer.mha2.wq, layer.mha2.wk,
                        layer.mha2.wv, layer.mha2.dense, layer.ffn[1], layer.ffn[3]):
                ops += list(lin.cast(BF))
            ops += [None] * 6
        weights = tk.bottleneck_weights(m.att_dense.cast(BF)[0], ops, 2)
        assert torch.equal(tiles, tk.bottleneck_tiles(weights, 6))
        m.att_layers[1].ffn[3].weight.add_(1.0)
        again = m.bottleneck_tiles()
    assert again is not tiles and not torch.equal(again, tiles)


def test_bottleneck_wrapper_refusals():
    """The wrapper refuses what the kernel cannot take on every device: more
    heads than a cluster holds, a row longer than 256, and a spilled row
    whose slices exceed shared memory."""
    _, o = _operands(np.random.RandomState(0), 2, 6, 144, 9, 7, cin=64)
    with pytest.raises(ValueError, match="at most 8 CTAs"):
        tk.fused_bottleneck(o["x"], o["aw"], o["ab"], o["pe"], o["neg"], o["ops"], 1, 9)
    _, o = _operands(np.random.RandomState(1), 1, 257, 96, 6, 5, cin=16)
    with pytest.raises(ValueError, match="rows and keys"):
        tk.fused_bottleneck(o["x"], o["aw"], o["ab"], o["pe"], o["neg"], o["ops"], 1, 6)
    _, o = _operands(np.random.RandomState(1), 1, 250, 384, 3, 5, cin=16)
    with pytest.raises(ValueError, match="shared memory"):
        tk.fused_bottleneck(o["x"], o["aw"], o["ab"], o["pe"], o["neg"], o["ops"], 1, 3)


@pytest.mark.parametrize("t8,fits", [(49, True), (73, True), (74, False)])
def test_bottleneck_gate_follows_the_kernel_limit(monkeypatch, t8, fits):
    """The sampler takes the bottleneck kernel at every row length. At the
    canonical width a row up to T8 = 73 is held in the cluster's shared
    memory (`fits`) and a longer one spills to a workspace; the model's
    gate does not look at T (a small model, the wrapper forced on, here
    running its plain version)."""
    from dhg_torch.models import denoiser

    assert (tk.bottleneck_layout(t8, 256, 384, 6, 50)[1] == 0) == fits
    assert tk.bottleneck_refusal(t8, 256, 384, 6, 50) is None
    monkeypatch.setenv("DHG_FUSED_BOTTLENECK", "1")
    rows = []

    def spy(x, *rest, **kw):
        rows.append(x.shape[1])
        return tk.fused_bottleneck(x, *rest, **kw)

    monkeypatch.setattr(denoiser, "fused_bottleneck", spy)
    torch.manual_seed(t8)
    m = denoiser.DiffusionModel(num_layers=1, c1=32, c2=48, c3=64, dtype=BF).eval()
    text, style = torch.randint(1, 20, (1, 6)), torch.randn(1, 14, 1280)
    with torch.no_grad():
        se = m.embed_sigma(torch.full((1, 1), 0.5))
        cond = m.encode_cond(text, style, se)
        kvs, films = m.precompute_cross_kv(cond, se), m.precompute_film(se)
        eps, _ = m.denoise(torch.randn(1, 8 * t8, 2), None, None, create_padding_mask(text),
                           kvs=kvs, films=films)
    assert rows == [t8]
    assert eps.shape == (1, 8 * t8, 2) and bool(torch.isfinite(eps).all())


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
