"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel against its plain PyTorch version on the same bf16 operands at
the bf16 bar (rtol = atol = 0.05, median |diff| < 5e-3), at small and
main-path shapes; the forward-only guard; the launch counts of a bf16
generate. No JAX here, so it runs where the card is:
    python -m pytest -m cuda tests/test_torch_port_cuda.py -q
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
