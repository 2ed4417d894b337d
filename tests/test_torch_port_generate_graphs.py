"""generate's CUDA-graph front end, the parts that run on the CPU: the
draws made before a replay (core/sampling.py::sampler_draws) and the key
graphs are cached by (core/graphs.py::SamplerGraphs.key).

The port against itself, on paths tests/test_torch_port_sampler.py holds
to dhg, so no JAX runs here: a small model (channels 16, one attention
layer, random weights from seed 0), seq_len 16, 10 steps. The replays
themselves are in tests/test_torch_port_generate_graphs_cuda.py.
"""

import numpy as np
import pytest
import torch

from dhg_torch import inference
from dhg_torch.core.graphs import SamplerGraphs
from dhg_torch.core.sampling import sampler_draws
from dhg_torch.inference import generate
from dhg_torch.models.denoiser import DiffusionModel

SEQ_LEN, N_STEPS = 16, 10


@pytest.fixture(scope="module")
def model():
    return DiffusionModel.from_config({"channels": 16, "att_layers_num": 1}, device="cpu",
                                      seed=0).eval()


def _inputs(b=2, seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randint(2, 73, (b, 6))
    text[:, 4], text[:, 5] = 1, 0  # EOS, then padding
    return torch.from_numpy(text), torch.from_numpy(rng.randn(b, 14, 1280).astype(np.float32))


def _generate(model, text, style, mode, **kw):
    return generate(model, text, style, seq_len=SEQ_LEN, diffusion_mode=mode, n_steps=N_STEPS,
                    device="cpu", **kw)


@pytest.mark.parametrize("mode, kw", [("new", {}), ("standard", {}), ("ddim", {}),
                                      ("new", {"encoder_reuse": 2}),
                                      ("new", {"temperature": 0.8})],
                         ids=["new", "standard", "ddim", "encoder_reuse_2", "temperature_0.8"])
def test_draws_give_the_generators_strokes(model, mode, kw):
    """sampler_draws' x_init / noises give generate(generator=...)'s
    strokes bit for bit, and leave the generator where it leaves it."""
    text, style = _inputs()
    g_eager, g_drawn = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = _generate(model, text, style, mode, generator=g_eager, **kw)
    x, z = sampler_draws(2, SEQ_LEN, N_STEPS, mode, g_drawn, "cpu")
    got = _generate(model, text, style, mode, x_init=x, noises=z, **kw)
    assert torch.equal(got, want)
    assert torch.equal(g_drawn.get_state(), g_eager.get_state())


def test_draws_from_the_default_generator(model):
    text, style = _inputs(seed=1)
    with torch.random.fork_rng():
        torch.manual_seed(3)
        want = _generate(model, text, style, "new")
        state = torch.get_rng_state()
        torch.manual_seed(3)
        x, z = sampler_draws(2, SEQ_LEN, N_STEPS, "new", None, "cpu")
        assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(_generate(model, text, style, "new", x_init=x, noises=z), want)


def test_key_normalises_as_generate():
    key = SamplerGraphs.key
    base = key(2, 16)
    assert base == key(2, 16, "new", None, None, "strided", None, None, None, 50)
    assert key(2, 16, guidance_scale=1.0) == base  # guidance 1 is unguided
    assert key(2, 16, guidance_scale=1.5) == key(2, 16, guidance_scale=3.0) != base
    assert key(2, 16, n_steps=60) == key(2, 16, n_steps=60, schedule="halved") == base
    assert key(2, 16, n_steps=30) != key(2, 16, n_steps=30, schedule="halved")
    assert key(2, 16, temperature=1.0) == base != key(2, 16, temperature=0.8)
    assert key(2, 16, mode="bogus") == base != key(2, 16, mode="ddim")
    assert key(2, 16, hoist="compact") == base != key(2, 16, hoist="full")
    assert key(2, 16, encoder_reuse=1) == base
    assert len({base, key(2, 16, encoder_reuse=2), key(2, 16, encoder_reuse=3)}) == 3
    # Reuse runs on the full hoist whatever hoist says.
    assert key(2, 16, hoist="compact", encoder_reuse=2) == key(2, 16, hoist="full",
                                                                 encoder_reuse=2)
    assert len({base, key(1, 16), key(2, 24), key(2, 16, text_len=6)}) == 4


@pytest.mark.parametrize("name, values", [("DHG_FUSED_BOTTLENECK", ("auto", "0", "1")),
                                          ("DHG_FUSED_T4", ("0", "1")),
                                          ("DHG_FUSED_ATTENTION", ("0", "1")),
                                          ("DHG_FUSED_CONVBLOCK", ("0", "1"))])
def test_key_carries_each_kernel_mode(monkeypatch, name, values):
    """A graph bakes in the path it captured, so each mode the traced path
    reads from the environment is part of the key."""
    keys = []
    for v in values:
        monkeypatch.setenv(name, v)
        keys.append(SamplerGraphs.key(2, 16))
    assert len(set(keys)) == len(values)


def test_cpu_generate_stays_eager(model):
    text, style = _inputs()
    _generate(model, text, style, "new", generator=torch.Generator().manual_seed(0))
    assert model not in inference._graphs
    with pytest.raises(ValueError, match="CUDA"):
        SamplerGraphs(model, "cpu")
    with pytest.raises(ValueError, match="pass both"):
        _generate(model, text, style, "new", x_init=torch.zeros(2, SEQ_LEN, 2))
