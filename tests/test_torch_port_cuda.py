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


# (B, T, D, heads, L): a small case, enc3 and enc5 at seq_len 392 and batch
# 96, 1 and 8; T 37 (one CTA) and 131 (3 CTAs of 44, the last 43: no
# multiple of 16 or of the cluster); a 50-token prompt's enc3 and enc5 (T
# 404 over 7 CTAs and 202 over 4); the longest rows (T 1024 at enc3's width,
# a non-portable 16-CTA cluster, two-pass self-attention; 512 at enc5's);
# more than 64 and more than 256 text keys; one head of 64 and 8 of 16.
ENCODER_LAYER_CASES = [(8, 24, 48, 3, 7), (96, 196, 192, 3, 50), (96, 98, 256, 4, 50),
                       (1, 196, 192, 3, 50), (1, 98, 256, 4, 50), (8, 196, 192, 3, 50),
                       (8, 98, 256, 4, 50), (4, 37, 192, 3, 50), (4, 131, 192, 3, 50),
                       (96, 404, 192, 3, 50), (96, 202, 256, 4, 50), (2, 1024, 192, 3, 50),
                       (2, 512, 256, 4, 50), (3, 98, 256, 4, 100), (3, 60, 64, 4, 300),
                       (3, 70, 64, 1, 20), (3, 70, 128, 8, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_len,d,heads,l", ENCODER_LAYER_CASES)
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
def test_cuda_encoder_layer_clusters_fit(cuda):
    """encoder_layer_layout agrees with the kernel's layout at every case,
    and the card schedules a cluster of each (16 CTAs included)."""
    from dhg_torch.kernels.build import load

    lib = load()
    for _, t, d, heads, l in ENCODER_LAYER_CASES:
        assert (lib.dhg_encoder_layer_cluster(t, d, heads), lib.dhg_encoder_layer_rows(t, d, heads),
                lib.dhg_encoder_layer_smem_bytes(t, d, heads)) == tk.encoder_layer_layout(t, d, heads)
        assert lib.dhg_encoder_layer_max_clusters(t, d, heads, l) >= 1


# (B, T, Cin, D, L, heads, layers): the small case with 6, 3 and 8 heads,
# then the canonical width (T8 = 49 at seq_len 392, 50 text tokens) at the
# sampler's batches with 1 and 2 layers, 8 heads of 48, the longest row a
# cluster's shared memory holds at D = 384 (T = 73), then spilled rows: T 74
# (a 37-token prompt), T 101 (a 50-token one) at batch 2 and 96, T 256 with
# 8 heads, a head dim of 128, and more than 128 keys.
BOTTLENECK_CASES = [(3, 6, 64, 96, 7, 6, 2), (3, 6, 64, 96, 7, 3, 2), (3, 6, 64, 128, 7, 8, 2),
                    (1, 49, 256, 384, 50, 6, 2), (96, 49, 256, 384, 50, 6, 2),
                    (1, 49, 256, 384, 50, 6, 1), (2, 49, 256, 384, 50, 6, 1),
                    (2, 49, 256, 384, 50, 6, 2), (5, 49, 256, 384, 50, 6, 2),
                    (256, 49, 256, 384, 50, 6, 2), (96, 49, 256, 384, 50, 6, 1),
                    (4, 49, 256, 384, 50, 8, 2), (4, 49, 256, 384, 50, 3, 1),
                    (2, 73, 256, 384, 50, 6, 2), (2, 74, 256, 384, 50, 6, 2),
                    (2, 101, 256, 384, 50, 6, 2), (96, 101, 256, 384, 50, 6, 2),
                    (2, 256, 256, 384, 50, 8, 1), (2, 101, 256, 384, 50, 3, 1),
                    (3, 20, 64, 96, 200, 6, 2), (5, 150, 64, 96, 7, 6, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_len,cin,d,l,heads,n_layers", BOTTLENECK_CASES)
def test_cuda_bottleneck_matches_plain(cuda, b, t_len, cin, d, l, heads, n_layers):
    _, o = kernel_operands(np.random.RandomState(b), b, t_len, d, heads, l, cin=cin,
                           n_layers=n_layers, device=cuda)
    args = (o["x"], o["aw"], o["ab"], o["pe"], o["neg"], o["ops"], n_layers, heads)
    with torch.no_grad():
        n = tk.launches["fused_bottleneck"]
        ours = tk.fused_bottleneck(*args)
        torch.cuda.synchronize()
        assert tk.launches["fused_bottleneck"] == n + 1
        ref = tk.bottleneck_plain(*args)
    assert ours.shape == (b, t_len, d)
    _close(ours, ref)


@pytest.mark.cuda
def test_cuda_bottleneck_clusters_fit(cuda):
    """The canonical cluster (6 CTAs of 167,040 bytes) and a spilled one are
    schedulable; bottleneck_layout agrees with the kernel's layout."""
    from dhg_torch.kernels.build import load

    lib = load()
    for shape in ((49, 256, 384, 6, 50), (101, 256, 384, 6, 50)):
        assert lib.dhg_bottleneck_max_clusters(*shape) >= 1
    for case in BOTTLENECK_CASES:
        b, t, cin, d, l, heads, _ = case
        shape = (t, cin, d, heads, l)
        assert (lib.dhg_bottleneck_smem_bytes(*shape),
                lib.dhg_bottleneck_workspace_elems(*shape)) == tk.bottleneck_layout(*shape)


# (B, T4, c2, c3, d, L, layers), each over the fewest CTAs that fit: the
# small model in one CTA and over 3 CTAs of 44, 44 and 42 rows (every key
# staged at once); the canonical widths at seq_len 392 (2 CTAs of 50 and 48
# rows) at batch 1, 8 and 96; a 50-token prompt's T4 = 202 (4 CTAs of 52) at
# batch 96; 3 CTAs of 36 (every enc5 key staged at once); 6 CTAs of 44, 7 of
# 46 and 8 of 52 (T4 = 262, 314, 416); more text keys than are staged at once.
T4_CASES = [(2, 12, 48, 64, 96, 7, 2), (2, 130, 48, 64, 96, 7, 1),
            (1, 98, 192, 256, 384, 50, 2), (96, 98, 192, 256, 384, 50, 2),
            (8, 98, 192, 256, 384, 50, 2), (96, 202, 192, 256, 384, 50, 2),
            (3, 106, 192, 256, 384, 50, 2), (2, 262, 192, 256, 384, 50, 2),
            (3, 314, 192, 256, 384, 50, 1), (1, 416, 192, 256, 384, 50, 1),
            (2, 98, 192, 256, 384, 300, 2)]


def _t4_args(b, t4, c2, c3, d, l, n_layers, device):
    from test_torch_port_operands import t4_operands

    _, o = t4_operands(np.random.RandomState(b + t4), b, t4, c2, c3, d, 4, 6, l, n_layers,
                       device=device)
    return [o[k] for k in ("x", "neg", "pe4", "pe8", "aw", "ab", "sk3w", "sk3b",
                           "enc4", "enc5", "dec3", "att")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t4,c2,c3,d,l,n_layers", T4_CASES)
def test_cuda_unet_t4_matches_plain(cuda, b, t4, c2, c3, d, l, n_layers):
    args = _t4_args(b, t4, c2, c3, d, l, n_layers, cuda)
    with torch.no_grad():
        n = tk.launches["fused_unet_t4"]
        ours = tk.fused_unet_t4(*args, n_layers, 6, 4)
        torch.cuda.synchronize()
        assert tk.launches["fused_unet_t4"] == n + 1
        ref = tk.unet_t4_plain(*args, n_layers, 6, 4)
    assert ours.shape == (b, t4, c3)
    _close(ours, ref)


@pytest.mark.cuda
def test_cuda_unet_t4_layout_and_refusal(cuda):
    """t4_layout agrees with the kernel's layout at every case and the card
    schedules a cluster of each; a row past the kernel's limit raises from
    t4_refusal before any launch."""
    from dhg_torch.kernels.build import load

    lib = load()
    for _, t4, c2, c3, d, _, _ in T4_CASES:
        shape = (t4, c2, c3, d, 4, 6)
        assert (lib.dhg_unet_t4_cluster(*shape), lib.dhg_unet_t4_rows(*shape),
                lib.dhg_unet_t4_keys(*shape), lib.dhg_unet_t4_smem_bytes(*shape)) == \
            tk.t4_layout(*shape)
        assert lib.dhg_unet_t4_max_clusters(*shape, 50) >= 1
    args = _t4_args(1, 420, 192, 256, 384, 50, 1, cuda)
    n = tk.launches["fused_unet_t4"]
    with torch.no_grad(), pytest.raises(ValueError, match="fused_unet_t4: T4 = 420"):
        tk.fused_unet_t4(*args, 1, 6, 4)
    assert tk.launches["fused_unet_t4"] == n


@pytest.mark.cuda
def test_cuda_t4_generate_launch_counts(cuda, monkeypatch):
    """DHG_FUSED_T4=1: one fused_unet_t4 launch a step, no other sampler
    kernel (enc3 runs its plain attend, as in dhg)."""
    from dhg_torch.inference import generate
    from dhg_torch.models.denoiser import DiffusionModel

    monkeypatch.setenv("DHG_FUSED_T4", "1")
    model = DiffusionModel.from_config({"channels": 128}, dtype=BF, device=cuda)
    rng = np.random.RandomState(1)
    text = rng.randint(2, 73, (8, 10))
    style = rng.randn(8, 14, 1280).astype(np.float32)
    tk.reset_launch_counts()
    out = generate(model, text, style, torch.Generator(cuda).manual_seed(0), seq_len=64,
                   n_steps=4, device=cuda)
    torch.cuda.synchronize()
    assert out.shape == (8, 64, 3) and torch.isfinite(out).all()
    assert tk.launches == {"fused_unet_t4": 4, "fused_bottleneck": 0, "fused_encoder_layer": 0}


@pytest.mark.cuda
def test_cuda_kernels_refuse_autograd(cuda):
    _, o = kernel_operands(np.random.RandomState(0), 2, 8, 48, 3, 5, device=cuda)
    x = o["x"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tk.fused_encoder_layer(x, o["pe"], o["neg"], o["ops"], 3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq_len,counts", [(8, 64, (4, 8)), (1, 64, (4, 0)),
                                                  (8, 808, (4, 8)), (1, 808, (4, 0))])
def test_cuda_generate_launch_counts(cuda, batch, seq_len, counts):
    """Canonical widths, 4 strided steps: bottleneck once a step, enc3 and
    enc5 twice a step when 8 <= batch <= 128, at a short row and at the
    808 steps of a 50-token prompt (T8 = 101: the bottleneck spills)."""
    from dhg_torch.inference import generate
    from dhg_torch.models.denoiser import DiffusionModel

    model = DiffusionModel.from_config({"channels": 128}, dtype=BF, device=cuda)
    rng = np.random.RandomState(0)
    text = rng.randint(2, 73, (batch, 50))
    style = rng.randn(batch, 14, 1280).astype(np.float32)
    tk.reset_launch_counts()
    out = generate(model, text, style, torch.Generator(cuda).manual_seed(0), seq_len=seq_len,
                   n_steps=4, device=cuda)
    torch.cuda.synchronize()
    assert out.shape == (batch, seq_len, 3) and torch.isfinite(out).all()
    assert (tk.launches["fused_bottleneck"], tk.launches["fused_encoder_layer"]) == counts


@pytest.mark.cuda
def test_cuda_long_prompt_denoise_matches_plain(cuda, monkeypatch):
    """A batch padded to a 50-token prompt (T8 = 101, a spilled row) takes
    the bottleneck kernel, and its bf16 denoise matches the plain module
    path."""
    from dhg_torch.core.schedule import get_alpha_set
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.ops.basic import create_padding_mask

    model = DiffusionModel.from_config({"channels": 128}, dtype=BF, device=cuda)
    rng = np.random.RandomState(3)
    lengths = [50, 24, 9, 37]
    text = np.zeros((4, 50), np.int64)
    for i, n in enumerate(lengths):
        text[i, :n] = rng.randint(2, 73, n)
    text = torch.from_numpy(text).to(cuda)
    style = torch.from_numpy(rng.randn(4, 14, 1280).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.randn(4, 808, 2).astype(np.float32)).to(cuda)
    with torch.no_grad():
        se = model.embed_sigma(torch.sqrt(get_alpha_set()[20]).reshape(1, 1).to(cuda))
        cond = model.encode_cond(text, style, se)
        kvs, films = model.precompute_cross_kv(cond, se), model.precompute_film(se)
        mask = create_padding_mask(text)
        tk.reset_launch_counts()
        eps_k, pen_k = model.denoise(x, None, None, mask, kvs=kvs, films=films)
        torch.cuda.synchronize()
        assert tk.launches["fused_bottleneck"] == 1
        monkeypatch.setenv("DHG_FUSED_BOTTLENECK", "0")
        eps_p, pen_p = model.denoise(x, None, None, mask, kvs=kvs, films=films)
    _close(eps_k, eps_p)
    _close(pen_k, pen_p)


def _attention_inputs(b, h, tq, tk, d, masked, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=g).to(device, dtype) for n in (tq, tk, tk))
    mask = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b,), generator=g)
        mask = (torch.arange(tk)[None] >= lengths[:, None]).float()[:, None, None].to(device)
    return q, k, v, mask


# (B, H, Tq, Tk, D, masked): small cases (ragged Tq and Tk, Tk not a
# multiple of 16, D 12 as at channels 32, Tk > 256 for the two-pass softmax,
# D 128), then the training path at T = 480: text-style cross-attention, and
# enc3 / enc5 / att_layers cross and self.
ATTENTION_SHAPES = [(2, 3, 5, 7, 16, False), (3, 2, 70, 33, 48, True), (2, 3, 50, 70, 48, True),
                    (2, 8, 10, 14, 12, False), (2, 2, 40, 300, 64, True),
                    (2, 2, 17, 129, 128, True), (96, 8, 50, 70, 48, False),
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 50, 70, 48), (4, 3, 240, 240, 64), (2, 2, 33, 41, 64),
                                   (2, 2, 20, 300, 64), (2, 3, 40, 600, 48)])
def test_cuda_attention_passes_match_plain(cuda, shape):
    """Both bf16 softmax variants (logits in registers up to 256 keys, two
    passes above), with one row whose mask leaves one key."""
    from dhg_torch.kernels import fused_attention as fa

    q, k, v, mask = _attention_inputs(*shape, True, BF, cuda)
    mask[0, ..., 1:] = 1.0
    ours = fa.fused_attention(q, k, v, mask)
    _close(ours, fa.attention_plain(q, k, v, mask))
    torch.testing.assert_close(ours[0].float(), v[0, :, :1].float().expand_as(ours[0]),
                               rtol=0, atol=0)


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


# (B, T, Cin, Co): small and ragged cases, then the six training-path blocks,
# then ragged T around the kernel's 62-row tile (1, 2, 17, 61, 62, 63) at
# training widths, and a Co past one 256-column pass.
CONV_SHAPES = [(2, 5, 8, 16), (3, 70, 24, 48), (96, 480, 128, 128), (96, 240, 128, 192),
               (96, 120, 192, 256), (96, 120, 384, 256), (96, 240, 256, 192), (96, 480, 192, 128),
               (3, 1, 384, 256), (3, 2, 128, 192), (3, 17, 192, 256), (3, 61, 256, 192),
               (3, 62, 384, 256), (3, 63, 192, 128), (2, 40, 36, 264)]


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
    else:  # 3xTF32 tensor-core products, sums in another order
        np.testing.assert_allclose(ours.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_conv_block_f32_accuracy(cuda):
    """At dec3's widths in f32 the kernel stays within 1e-5 of the output's
    scale of conv_block_plain in float64; the plain version with TF32
    products (one pass, 10-bit mantissas) does not, so the bar has teeth."""
    from dhg_torch.kernels import fused_conv_block as fc

    x, ops = _conv_block_inputs(8, 120, 384, 256, torch.float32, cuda, seed=3)
    ref = fc.conv_block_plain(x.double(), *[o.double() for o in ops])
    scale = float(ref.abs().max())

    def rel(out):
        return float((out.double() - ref).abs().max()) / scale

    assert rel(fc.fused_conv_block(x, *ops)) <= 1e-5
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = rel(fc.conv_block_plain(x, *ops))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert tf32 > 1e-5


@pytest.mark.cuda
def test_cuda_conv_block_layout(cuda):
    """conv_block_layout agrees with the kernel's tile, threads, ring slots
    and shared memory at every case, and the card holds a CTA of each."""
    from dhg_torch.kernels import fused_conv_block as fc
    from dhg_torch.kernels.build import load

    lib = load()
    for _, _, cin, co in CONV_SHAPES:
        assert (lib.dhg_conv_block_tile(), lib.dhg_conv_block_threads(co),
                lib.dhg_conv_block_slots(cin, co), lib.dhg_conv_block_smem_bytes(cin, co)) == \
            fc.conv_block_layout(cin, co)
        for is_bf16 in (0, 1):
            assert lib.dhg_conv_block_ctas_per_sm(cin, co, is_bf16) >= 1
    x, ops = _conv_block_inputs(1, 4, 1024, 512, torch.float32, cuda)
    n = fc.launches["fused_conv_block"]
    with pytest.raises(ValueError, match="fused_conv_block: widths Cin 1024, Co 512"):
        fc.fused_conv_block(x, *ops)
    assert fc.launches["fused_conv_block"] == n


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
