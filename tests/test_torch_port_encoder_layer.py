"""csrc/encoder_layer.cu's launch shape and weight tiles, on the CPU.

The kernel splits one batch row over a thread-block cluster by sequence
rows; these tests hold the Python side that the kernel relies on: the
layout mirror (CTAs, rows a CTA, shared memory), the refusals, the tiled
weights read back with the kernel's swizzled addressing, and the model's
cached copy of those tiles. No JAX: the arithmetic is held to dhg by
test_torch_port_kernels.py, the kernel to its plain version on the card by
test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

from dhg_torch.kernels import fused_bottleneck as tk
from test_torch_port_operands import kernel_operands

BF = torch.bfloat16


# (T, D, heads) -> (CTAs, rows a CTA, shared memory bytes): enc3 and enc5 at
# seq_len 392 and at a 50-token prompt's 808 (at width 256 with 208 keys
# staged a CTA fits 41 rows, so 202 takes 5 CTAs), the longest rows (16 CTAs
# above 8 are a non-portable cluster; past 256 keys two softmax passes over
# chunks of 64), a short row in one CTA, a row no multiple of 16 or of C.
@pytest.mark.parametrize("shape,want", [
    ((196, 192, 3), (4, 49, 219392)), ((98, 256, 4), (2, 49, 215296)),
    ((404, 192, 3), (7, 58, 182656)), ((202, 256, 4), (5, 41, 228096)),
    ((1024, 192, 3), (16, 64, 194944)), ((512, 256, 4), (9, 57, 219008)),
    ((37, 192, 3), (1, 37, 137344)), ((131, 192, 3), (3, 44, 182784)),
])
def test_encoder_layer_launch_shape(shape, want):
    assert tk.encoder_layer_layout(*shape) == want
    assert tk.encoder_layer_refusal(*shape) is None
    c, tc, smem = want
    assert (c - 1) * tc < shape[0] <= c * tc and smem <= tk.MAX_SMEM


@pytest.mark.parametrize("shape,why", [((1025, 192, 3), "at most 16 CTAs"),
                                       ((993, 256, 4), "at most 16 CTAs"),
                                       ((98, 384, 6), "width 384 > 256"),
                                       ((98, 144, 9), "at most 8"),
                                       ((98, 256, 2), "head dim 128")])
def test_encoder_layer_refusal_names_the_limit(shape, why):
    assert why in tk.encoder_layer_refusal(*shape)


@pytest.mark.parametrize("b,t_len,d,heads,match", [(1, 1025, 48, 3, "at most 16 CTAs"),
                                                   (2, 8, 144, 9, "at most 8"),
                                                   (2, 8, 128, 1, "head dim 128")])
def test_encoder_layer_wrapper_refusals(b, t_len, d, heads, match):
    """The wrapper refuses what the kernel cannot take on every device."""
    _, o = kernel_operands(np.random.RandomState(0), b, t_len, d, heads, 5)
    with pytest.raises(ValueError, match=match):
        tk.fused_encoder_layer(o["x"], o["pe"], o["neg"], o["ops"], heads)


@pytest.mark.parametrize("d", [48, 96, 192])
def test_encoder_layer_tiles_follow_the_kernel_addressing(d):
    """encoder_layer_tiles lays one layer's 8 weights out in the order the
    ring streams them (wq, wo, wv2, wq2, wk2, wo2, fc1, fc2), in [64, 128]
    tiles; reading each tile with the kernel's swizzled address (chunk c of
    row n at c ^ (n & 7)) gives the weight back, zero-padded to whole tiles,
    and the count is the kernel's tiles_for(D)."""
    _, o = kernel_operands(np.random.RandomState(d), 1, 4, d, 3, 5)
    weights = [o["ops"][j] for j in tk.SCHEDULE]
    tiles = tk.encoder_layer_tiles(weights)
    n, n2, k, k2 = -(-d // 64), -(-2 * d // 64), -(-d // 128), -(-2 * d // 128)
    assert tiles.shape == (6 * n * k + n2 * k + n * k2, 64, 128)
    rows = torch.arange(64)[:, None]
    col = torch.arange(128)[None, :]
    phys = ((col // 8) ^ (rows & 7)) * 8 + col % 8
    cursor = 0
    for w in weights:
        for c0 in range(0, w.shape[0], 64):
            for k0 in range(0, w.shape[1], 128):
                want = torch.zeros(64, 128)
                part = w[c0:c0 + 64, k0:k0 + 128].float()
                want[:part.shape[0], :part.shape[1]] = part
                assert torch.equal(tiles[cursor].float().gather(1, phys), want)
                cursor += 1
    assert cursor == tiles.shape[0]


def test_model_encoder_layer_tiles_are_cached_per_weight_set():
    """DiffusionModel.encoder_layer_tiles keeps each layer's tiles in that
    layer's cast cache: the same tensor again, one copy per layer, a new one
    after a weight of that layer changes."""
    from dhg_torch.models.denoiser import DiffusionModel

    m = DiffusionModel(num_layers=1, c1=32, c2=48, c3=64, dtype=BF).eval()

    def scheduled(layer):
        return [lin.weight.to(BF) for lin in (layer.mha.wq, layer.mha.dense, layer.mha2.wv,
                                              layer.mha2.wq, layer.mha2.wk, layer.mha2.dense,
                                              layer.ffn[1], layer.ffn[3])]

    with torch.no_grad():
        t3, t5 = m.encoder_layer_tiles(m.enc3), m.encoder_layer_tiles(m.enc5)
        assert m.encoder_layer_tiles(m.enc3) is t3 and m.encoder_layer_tiles(m.enc5) is t5
        assert torch.equal(t3, tk.encoder_layer_tiles(scheduled(m.enc3)))
        assert torch.equal(t5, tk.encoder_layer_tiles(scheduled(m.enc5)))
        m.enc3.mha2.wk.weight.add_(1.0)
        again = m.encoder_layer_tiles(m.enc3)
        assert m.encoder_layer_tiles(m.enc5) is t5
    assert again is not t3 and not torch.equal(again, t3)
    assert torch.equal(again, tk.encoder_layer_tiles(scheduled(m.enc3)))
