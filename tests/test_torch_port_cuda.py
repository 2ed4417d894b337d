"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel against its plain PyTorch version on the same operands, at
small and main-path shapes: bf16 at the bf16 bar (rtol = atol = 0.05,
median |diff| < 5e-3), f32 at 1e-4 (sums in another order); the
forward-only guard; both autograd.Functions against the plain backward;
the launch counts of a bf16 generate and of a training step. No JAX here,
so it runs where the card is (tests/conftest.py imports jax, hence
--noconftest):
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dhg_torch.kernels import fused_bottleneck as tk
from test_torch_port_operands import kernel_operands

BF = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b):
    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)
    assert np.median(np.abs(a - b)) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_len,d,heads,l", [(8, 24, 48, 3, 7), (96, 196, 192, 3, 50),
                                               (96, 98, 256, 4, 50)])
def test_cuda_encoder_layer_matches_plain(cuda, b, t_len, d, heads, l):
    _, o = kernel_operands(np.random.RandomState(d), b, t_len, d, heads, l, device=cuda)
    with torch.no_grad():
        n = tk.launches["fused_encoder_layer"]
        ours = tk.fused_encoder_layer(o["x"], o["pe"], o["neg"], o["ops"], heads)
        torch.cuda.synchronize()
        assert tk.launches["fused_encoder_layer"] == n + 1
        ref = tk.encoder_layer_plain(o["x"], o["pe"], o["neg"], o["ops"], heads)
    _close(ours, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_len,cin,d,l", [(3, 6, 64, 96, 7), (1, 49, 256, 384, 50),
                                             (96, 49, 256, 384, 50)])
def test_cuda_bottleneck_matches_plain(cuda, b, t_len, cin, d, l):
    _, o = kernel_operands(np.random.RandomState(b), b, t_len, d, 6, l, cin=cin, n_layers=2,
                           device=cuda)
    with torch.no_grad():
        ours = tk.fused_bottleneck(o["x"], o["aw"], o["ab"], o["pe"], o["neg"], o["ops"], 2, 6)
        torch.cuda.synchronize()
        ref = tk.bottleneck_plain(o["x"], o["aw"], o["ab"], o["pe"], o["neg"], o["ops"], 2, 6)
    _close(ours, ref)


@pytest.mark.cuda
def test_cuda_kernels_refuse_autograd(cuda):
    _, o = kernel_operands(np.random.RandomState(0), 2, 8, 48, 3, 5, device=cuda)
    x = o["x"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tk.fused_encoder_layer(x, o["pe"], o["neg"], o["ops"], 3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,counts", [(8, (4, 8)), (1, (4, 0))])
def test_cuda_generate_launch_counts(cuda, batch, counts):
    """Canonical widths, 4 strided steps: bottleneck once a step, enc3 and
    enc5 twice a step when 8 <= batch <= 128."""
    from dhg_torch.inference import generate
    from dhg_torch.models.denoiser import DiffusionModel

    model = DiffusionModel.from_config({"channels": 128}, dtype=BF, device=cuda)
    rng = np.random.RandomState(0)
    text = rng.randint(2, 73, (batch, 10))
    style = rng.randn(batch, 14, 1280).astype(np.float32)
    tk.reset_launch_counts()
    out = generate(model, text, style, torch.Generator(cuda).manual_seed(0), seq_len=64,
                   n_steps=4, device=cuda)
    torch.cuda.synchronize()
    assert out.shape == (batch, 64, 3) and torch.isfinite(out).all()
    assert (tk.launches["fused_bottleneck"], tk.launches["fused_encoder_layer"]) == counts


def _attention_inputs(b, h, tq, tk, d, masked, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=g).to(device, dtype) for n in (tq, tk, tk))
    mask = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b,), generator=g)
        mask = (torch.arange(tk)[None] >= lengths[:, None]).float()[:, None, None].to(device)
    return q, k, v, mask


# (B, H, Tq, Tk, D, masked): small cases, then the training path at T = 480:
# text-style cross-attention, and enc3 / enc5 / att_layers cross and self.
ATTENTION_SHAPES = [(2, 3, 5, 7, 16, False), (3, 2, 70, 33, 48, True), (96, 8, 50, 70, 48, False),
                    (96, 3, 240, 50, 64, True), (96, 3, 240, 240, 64, False),
                    (96, 4, 120, 50, 64, True), (96, 4, 120, 120, 64, False),
                    (96, 6, 60, 50, 64, True), (96, 6, 60, 60, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_cuda_attention_matches_plain(cuda, shape, dtype):
    from dhg_torch.kernels import fused_attention as fa

    *dims, masked = shape
    q, k, v, mask = _attention_inputs(*dims, masked, dtype, cuda)
    n = fa.launches["fused_attention"]
    ours = fa.fused_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.launches["fused_attention"] == n + 1
    ref = fa.attention_plain(q, k, v, mask)
    if dtype == BF:
        _close(ours, ref)
    else:  # f32 sums in another order
        np.testing.assert_allclose(ours.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


def _conv_block_inputs(b, t_len, cin, co, dtype, device, film_batch=None, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, base=0.0):
        return (base + scale * torch.randn(*shape, generator=g)).to(device)

    c2, fb = co // 2, film_batch or b
    ops = [r(3, cin, co, scale=(3 * cin) ** -0.5), r(co, scale=0.1),
           r(3, cin, c2, scale=(3 * cin) ** -0.5), r(c2, scale=0.1),
           r(3, c2, co, scale=(3 * c2) ** -0.5), r(co, scale=0.1),
           r(co, co, scale=co ** -0.5), r(co, scale=0.1),
           r(fb, c2, scale=0.1, base=1.0), r(fb, c2, scale=0.1),
           r(fb, co, scale=0.1, base=1.0), r(fb, co, scale=0.1),
           r(fb, co, scale=0.1, base=1.0), r(fb, co, scale=0.1)]
    return r(b, t_len, cin).to(dtype), ops


# (B, T, Cin, Co): small and ragged cases, then the six training-path blocks.
CONV_SHAPES = [(2, 5, 8, 16), (3, 70, 24, 48), (96, 480, 128, 128), (96, 240, 128, 192),
               (96, 120, 192, 256), (96, 120, 384, 256), (96, 240, 256, 192), (96, 480, 192, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_cuda_conv_block_matches_plain(cuda, shape, dtype):
    from dhg_torch.kernels import fused_conv_block as fc

    x, ops = _conv_block_inputs(*shape, dtype, cuda)
    n = fc.launches["fused_conv_block"]
    ours = fc.fused_conv_block(x, *ops)
    torch.cuda.synchronize()
    assert fc.launches["fused_conv_block"] == n + 1
    ref = fc.conv_block_plain(x, *ops)
    if dtype == BF:
        _close(ours, ref)
    else:  # f32 FMAs, sums in another order
        np.testing.assert_allclose(ours.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_conv_block_batch1_film(cuda):
    from dhg_torch.kernels import fused_conv_block as fc

    x, ops = _conv_block_inputs(4, 40, 16, 32, torch.float32, cuda, film_batch=1)
    ours = fc.fused_conv_block(x, *ops)
    ref = fc.conv_block_plain(x, *ops)
    np.testing.assert_allclose(ours.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_autograd_functions_match_plain_backward(cuda):
    from dhg_torch.kernels.fused_attention import FusedAttention
    from dhg_torch.kernels.fused_conv_block import ConvBlockFn, conv_block_plain
    from dhg_torch.ops.attention import sdpa_math

    q, k, v, mask = _attention_inputs(2, 3, 24, 9, 16, True, BF, cuda)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    g = torch.randn(q.shape, device=cuda).to(BF)
    got = torch.autograd.grad(FusedAttention.apply(*leaves, mask), leaves, g)
    want = torch.autograd.grad(sdpa_math(*leaves, mask), leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    x, ops = _conv_block_inputs(2, 20, 16, 32, torch.float32, cuda)
    leaves = [t.requires_grad_(True) for t in (x, *ops)]
    g = torch.randn(2, 20, 32, device=cuda)
    got = torch.autograd.grad(ConvBlockFn.apply(*leaves), leaves, g)
    want = torch.autograd.grad(conv_block_plain(*leaves), leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_train_step_launch_counts(cuda, monkeypatch):
    """A bf16 training step with both flags on launches the attention kernel
    9 times (text-style, enc3 x2, enc5 x2, 2 att_layers x2) and the conv
    block kernel 6 times; the backward launches neither."""
    from dhg_torch.config import DLConfig
    from dhg_torch.kernels import fused_attention as fa, fused_conv_block as fc
    from dhg_torch.train import Trainer

    monkeypatch.setenv("DHG_FUSED_ATTENTION", "1")
    monkeypatch.setenv("DHG_FUSED_CONVBLOCK", "1")
    cfg = DLConfig({
        "experiment": {"seed": 0},
        "dataset_args": {"max_seq_len": 64, "max_text_len": 20},
        "training_args": {"channels": 32, "att_layers_num": 2, "batch_size": 4, "max_files": 8,
                          "warmup_steps": 100, "clip_grad": 100.0, "compute_dtype": "bfloat16",
                          "dataset": "synthetic"},
        "optimizer": {"type": "torch.optim.Adam", "params": {"betas": [0.9, 0.98]}},
    })
    trainer = Trainer(cfg, device=cuda)
    fa.reset_launch_count()
    fc.reset_launch_count()
    rows = [trainer.train_step(trainer.draw(c)) for c in (1, 2)]
    torch.cuda.synchronize()
    assert (fa.launches["fused_attention"], fc.launches["fused_conv_block"]) == (18, 12)
    assert torch.isfinite(torch.stack(rows)).all()
