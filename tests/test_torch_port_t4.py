"""The port's T/4 region kernel (fused_unet_t4) on the CPU.

(a) its plain version against dhg's Pallas kernel in interpret mode at
rows=1 on the same numpy-seeded bf16 operands; (b) the port's bf16 denoise
with DHG_FUSED_T4=1 against dhg's _denoise_fused_t4 on the same weights,
and the gate; (c) the kernel's host-side pieces, without JAX: the row
split, t4_refusal's limits and the tiled weights. Bar: the bf16 bar of tests/test_fused_bottleneck.py
(rtol = atol = 0.05, median |diff| < 5e-3). The CUDA kernel itself is held
to the plain version on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.kernels import fused_bottleneck as jk
from dhg.ops.basic import create_padding_mask as jmask
from dhg_torch.kernels import fused_bottleneck as tk
from dhg_torch.models import denoiser as tden
from dhg_torch.models.denoiser import DiffusionModel as TorchModel
from dhg_torch.ops.basic import create_padding_mask
from test_torch_port_common import (C1, N_LAYERS, assert_bf16_close, inputs, jax_model,
                                    port_model, random_params, t)
from test_torch_port_operands import t4_operands

BF = torch.bfloat16
C2, C3, D = C1 * 3 // 2, C1 * 2, C1 * 3  # 48, 64, 96


def _operands(n_layers, b=2, t4=12, l=7, seed=0):
    arrays, tensors = t4_operands(np.random.RandomState(seed), b, t4, C2, C3, D, 4, 6, l, n_layers)

    def jx(v):
        return tuple(jnp.asarray(a, jnp.bfloat16) for a in v) if isinstance(v, list) \
            else jnp.asarray(v, jnp.bfloat16)

    return {k: jx(v) for k, v in arrays.items()}, tensors


def _args(o):
    return [o[k] for k in ("x", "neg", "pe4", "pe8", "aw", "ab", "sk3w", "sk3b",
                           "enc4", "enc5", "dec3", "att")]


@pytest.mark.parametrize("n_layers", [1, 2])
def test_unet_t4_plain_matches_pallas(n_layers):
    j, o = _operands(n_layers, seed=n_layers)
    ref = jax.block_until_ready(jk.fused_unet_t4(*_args(j), num_layers=n_layers, att_heads=6,
                                                 enc5_heads=4, rows=1, interpret=True))
    before = dict(tk.launches)
    ours = tk.fused_unet_t4(*_args(o), n_layers, 6, 4)
    assert tk.launches == before  # the CPU path launches no kernel
    assert ours.dtype == BF and ours.shape == (2, 12, C3)
    assert_bf16_close(ours, ref)


def test_t4_wrapper_rejects_bad_operands():
    _, o = _operands(1)
    args = _args(o)
    with pytest.raises(ValueError, match="bfloat16"):
        tk.fused_unet_t4(args[0].float(), *args[1:], 1)
    with pytest.raises(ValueError, match="enc4: expected 14"):
        tk.fused_unet_t4(*args[:8], o["enc4"][:-1], *args[9:], 1)
    with pytest.raises(ValueError, match=r"skip3_b: shape"):
        tk.fused_unet_t4(*args[:7], o["sk3b"][:-1], *args[8:], 1)
    with pytest.raises(ValueError, match="attention-layer operands"):
        tk.fused_unet_t4(*args, 2)
    with pytest.raises(ValueError, match="head dim"):
        tk.fused_unet_t4(*args, 1, 6, 8)
    with pytest.raises(ValueError, match="even"):
        tk.fused_unet_t4(o["x"][:, :11].contiguous(), *args[1:], 1)


@pytest.fixture(scope="module")
def ctx():
    params = random_params(seed=9)
    return params, jax_model(jnp.bfloat16), port_model(params, BF)


def _port_context(pm, text, sigma, style):
    tx = t(text)
    se = pm.embed_sigma(t(sigma[:1]))
    cond = pm.encode_cond(tx, t(style), se)
    return pm.precompute_cross_kv(cond, se), pm.precompute_film(se), create_padding_mask(tx)


def test_t4_denoise_matches_dhg(ctx, monkeypatch):
    """B = 3, T = 48: the port's denoise takes the T4 path (its kernel's plain
    version on the CPU) and matches dhg's _denoise_fused_t4 (Pallas in
    interpret mode, rows=1)."""
    params, jm, pm = ctx
    strokes, text, sigma, style = inputs(batch=3, seq_len=48, text_len=6, seed=12)

    def run(m, s, tx, sg, st):
        se = m.embed_sigma(sg[:1])
        cond = m.encode_cond(tx, st, se)
        kvs, films = m.precompute_cross_kv(cond, se), m.precompute_film(se)
        return m._denoise_fused_t4(s, jmask(tx), kvs, films)

    # Finished before the port runs: XLA and torch never compute at once.
    eps, pen = jax.block_until_ready(jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=run))(
        params, strokes, text, sigma, style))

    calls = {"fused_unet_t4": 0, "fused_bottleneck": 0, "fused_encoder_layer": 0}

    def counted(name):
        fn = getattr(tden, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tden, name, counted(name))
    monkeypatch.setenv("DHG_FUSED_T4", "1")
    monkeypatch.setenv("DHG_FUSED_BOTTLENECK", "1")  # the T4 path takes precedence
    with torch.no_grad():
        kvs, films, mask = _port_context(pm, text, sigma, style)
        before = dict(tk.launches)
        oeps, open_ = pm.denoise(t(strokes), None, None, mask, kvs=kvs, films=films)
    assert tk.launches == before
    assert calls == {"fused_unet_t4": 1, "fused_bottleneck": 0, "fused_encoder_layer": 0}
    assert oeps.dtype == open_.dtype == torch.float32
    assert oeps.shape == (3, 48, 2) and open_.shape == (3, 48)
    assert_bf16_close(oeps, eps)
    assert_bf16_close(open_, pen)


def test_t4_gate(ctx, monkeypatch):
    """Off without the flag; off under train() with live dropout, without
    kvs/films, and in f32; on otherwise."""
    params, _, pm = ctx
    _, text, sigma, style = inputs(batch=2, seq_len=16, text_len=6, seed=1)
    cpu = torch.device("cpu")
    with torch.no_grad():
        kvs, films, _ = _port_context(pm, text, sigma, style)
    monkeypatch.delenv("DHG_FUSED_T4", raising=False)
    assert not pm._can_fuse_t4(kvs, films, cpu)
    monkeypatch.setenv("DHG_FUSED_T4", "1")
    assert pm._can_fuse_t4(kvs, films, cpu)
    assert not pm._can_fuse_t4(None, films, cpu) and not pm._can_fuse_t4(kvs, None, cpu)
    assert not port_model(params)._can_fuse_t4(kvs, films, cpu)  # f32 compute
    dropped = TorchModel(N_LAYERS, C1, C2, C3, drop_rate=0.1, dtype=BF)
    dropped.load_state_dict(pm.state_dict())
    assert dropped.eval()._can_fuse_t4(kvs, films, cpu)
    assert not dropped.train()._can_fuse_t4(kvs, films, cpu)


# T4 -> (CTAs, rows a CTA), the fewest CTAs that fit, at the canonical
# widths: seq_len 392 (2 of 50 and 48) and a 50-token prompt's 202 (4 of
# 52); the small model's 12 (one CTA); 106 (3 of 36, every enc5 key staged
# at once); 256, 262 and 314 (5, 6 and 7 CTAs); 416 (8 of 52, the longest).
SPLITS = [(98, 2, 50), (202, 4, 52), (12, 1, 12), (106, 3, 36), (256, 5, 52), (262, 6, 44),
          (314, 7, 46), (416, 8, 52)]


@pytest.mark.parametrize("t4,ctas,rows", SPLITS)
def test_t4_row_split(t4, ctas, rows):
    """Every CTA owns an even number of T/4 rows (so the pool's pairs and
    the upsample's sources stay in it), at most 64, and the CTAs cover the
    row once, in order."""
    got = tk.t4_layout(t4, 192, 256, 384, 4, 6)
    assert got[:2] == (ctas, rows) and got[3] <= tk.MAX_SMEM
    split = [(r, min(rows, t4 - r)) for r in range(0, t4, rows)]  # the kernel's (first row, rows)
    assert len(split) == ctas <= tk.MAX_CLUSTER
    assert [r for r, _ in split] == [c * rows for c in range(ctas)]
    assert all(n % 2 == 0 and 0 < n <= 64 for _, n in split)
    assert sum(n for _, n in split) == t4


def test_t4_refusal_limits():
    """Every T4 up to 416 at the canonical widths runs (seq_len 392's 98, a
    50-token prompt's 202); past that, and past the kernel's widths or
    heads, t4_refusal names the limit. It binds CUDA tensors only: on the
    CPU the wrapper computes a refused shape through unet_t4_plain."""
    canonical = (192, 256, 384, 4, 6)
    assert all(tk.t4_refusal(t4, *canonical) is None for t4 in range(2, 418, 2))
    assert tk.t4_layout(106, *canonical)[2] == 112  # 3 CTAs of 36: every key of enc5 at once
    assert tk.t4_layout(98, *canonical)[2] == tk.KEY_CHUNK  # 2 CTAs of 50: chunks of 64
    assert "T4 = 418" in tk.t4_refusal(418, *canonical)
    assert "widths" in tk.t4_refusal(98, 192, 512, 384, 8, 6)
    assert "heads" in tk.t4_refusal(98, 192, 256, 576, 4, 9)
    assert "head dims" in tk.t4_refusal(98, 192, 256, 384, 2, 6)
    assert "T4 = 520" in tk.t4_refusal(520, C2, C3, D, 4, 6)  # the small model: 8 CTAs of 66
    _, o = _operands(1, b=1, t4=520)
    args = _args(o)
    torch.testing.assert_close(tk.fused_unet_t4(*args, 1, 6, 4),
                               tk.unet_t4_plain(*args, 1, 6, 4), rtol=0, atol=0)


def _untile(tiles, rows, k):
    """The [rows, k] matrix that tk._cta_tiles cut into [64, 128] tiles."""
    nr, nk = -(-rows // 64), -(-k // 128)
    t = tiles.reshape(nr, nk, 64, 16, 8)
    chunk = (torch.arange(16)[None, :] ^ (torch.arange(64)[:, None] & 7))  # stored at chunk
    logical = torch.empty_like(t)
    logical[:, :, torch.arange(64)[:, None], chunk] = t
    return logical.permute(0, 2, 1, 3, 4).reshape(nr * 64, nk * 128)[:rows, :k]


def test_t4_tiles_hold_the_weights():
    """The model's cached T4 tiles are t4_weights' matrices in the kernel's
    order, each cut into swizzled [64, 128] tiles: untiled, each equals the
    weight it came from, zero padding aside; the tile count is the
    kernel's (t4_tiles in csrc/unet_t4.cu)."""
    model = TorchModel.from_config({"channels": C1, "att_layers_num": N_LAYERS}, dtype=BF,
                                   device="cpu", seed=2)
    with torch.no_grad():
        tiles = model.t4_tiles()
        assert model.t4_tiles() is tiles  # cached per weight set
        x4 = torch.zeros(1, 4, C2, dtype=BF)
        kvs = [(torch.zeros(1, h, 3, w // h), torch.zeros(1, h, 3, w // h))
               for h, w in ((3, C2), (4, C3)) + ((6, D),) * N_LAYERS]
        films = model.precompute_film(torch.zeros(1, C1 // 4))
        ops = model.t4_operands(x4, kvs, films, torch.zeros(1, 1, 1, 3))
    weights = tk.t4_weights(ops[4], ops[6], *ops[8:], N_LAYERS)
    assert len(weights) == 8 + 8 * (1 + N_LAYERS) + 2
    start = 0
    for w in weights:
        n = -(-w.shape[0] // 64) * -(-w.shape[1] // 128)
        assert torch.equal(_untile(tiles[start:start + n], *w.shape), w)
        start += n
    assert start == tiles.shape[0] and tiles.shape[1:] == (64, 128)
    def n(rows, k):
        return -(-rows // 64) * -(-k // 128)

    def block(cin, co):
        return n(co, 3 * cin) + n(co // 2, 3 * cin) + n(co, 3 * (co // 2)) + n(co, co)

    def layer(d):
        return 6 * n(d, d) + n(2 * d, d) + n(d, 2 * d)

    assert start == (block(C2, C3) + layer(C3) + n(D, C3) + N_LAYERS * layer(D) + n(D, 3 * C3)
                     + block(D, C3))
