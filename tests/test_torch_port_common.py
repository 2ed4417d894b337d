"""Shared set-up for the dhg_torch port tests: a small dhg model, its params
carried into the port by the weight bridge, and inputs made with numpy.

Helpers only: it defines no tests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from dhg.models.denoiser import DiffusionModel as JaxModel
from dhg_torch.models.denoiser import DiffusionModel as TorchModel
from dhg_torch.weights import state_dict_from_dhg

# The port's tests run tiny tensors through thousands of eager ops, where
# intra-op threads only add overhead: with one thread per process a 60-step
# CPU sampler call runs ~10x faster, and the pytest-xdist workers stop
# oversubscribing the cores (6 workers x 8 threads) that every test shares.
torch.set_num_threads(1)

C1 = 32  # c1/c2/c3 = 32/48/64, bottleneck 96 wide with 6 heads of 16
N_LAYERS = 2


def jax_model(dtype=None, c1=C1, num_layers=N_LAYERS) -> JaxModel:
    return JaxModel(num_layers=num_layers, c1=c1, c2=c1 * 3 // 2, c3=c1 * 2, dtype=dtype)


def random_params(seed=0, c1=C1, num_layers=N_LAYERS):
    """dhg params of the small model (nested numpy arrays) made by the
    port's seeded init and dhg's own torch -> dhg converter: the same
    distribution as dhg's init, without compiling dhg's init program (which
    takes ~25-40 s on the CPU)."""
    from dhg.tools.convert_torch_checkpoint import convert_state_dict

    model = TorchModel.from_config(
        {"channels": c1, "att_layers_num": num_layers}, device="cpu", seed=seed
    )
    return convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})


def port_model(params, dtype=None, c1=C1, num_layers=N_LAYERS) -> TorchModel:
    model = TorchModel(num_layers, c1, c1 * 3 // 2, c1 * 2, dtype=dtype)
    model.load_state_dict(state_dict_from_dhg(params), strict=True)
    return model.eval()


def inputs(batch=2, seq_len=16, text_len=6, seed=0):
    """(strokes [B,T,2], text [B,L] with padding, sigma [B,1], style [B,14,1280])."""
    rng = np.random.RandomState(seed)
    strokes = rng.randn(batch, seq_len, 2).astype(np.float32)
    text = rng.randint(2, 73, (batch, text_len)).astype(np.int32)
    for i in range(batch):  # EOS then padding, different lengths per row
        n = max(1, text_len - 1 - i)
        text[i, n] = 1
        text[i, n + 1:] = 0
    sigma = rng.uniform(0.1, 0.99, (batch, 1)).astype(np.float32)
    style = rng.randn(batch, 14, 1280).astype(np.float32)
    return strokes, text, sigma, style


def t(a, dtype=None):
    """numpy / jax array -> torch tensor (long for integer arrays)."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int64))
    out = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    return out.to(dtype) if dtype is not None else out


def f32(a) -> np.ndarray:
    """jax array or torch tensor -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_bf16_close(a, b):
    """The bf16 bar of tests/test_fused_bottleneck.py: rtol = atol = 0.05
    elementwise and a median |diff| under 5e-3."""
    a, b = f32(a), f32(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)
    assert np.median(np.abs(a - b)) < 5e-3, np.median(np.abs(a - b))
