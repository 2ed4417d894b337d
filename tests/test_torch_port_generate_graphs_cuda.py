"""generate's captured CUDA graphs on the card (marker `cuda`; skipped
without one): the canonical widths in bf16, where the sampler kernels run,
at 4 strided steps.

A key's first call runs eagerly, its second captures, its third replays;
each replay is held to the eager `_sample` with the same generator seed,
bit for bit, with the same kernel launches. No JAX here, so it runs where
the card is (tests/conftest.py imports jax, hence --noconftest):
    python -m pytest --noconftest -m cuda tests/test_torch_port_generate_graphs_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dhg_torch.core.graphs import SamplerGraphs
from dhg_torch.inference import _sample, beta_table, generate, sampler_graphs
from dhg_torch.kernels import fused_bottleneck as tk

SEQ_LEN, N_STEPS = 64, 4


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dhg_torch.models.denoiser import DiffusionModel

    return DiffusionModel.from_config({"channels": 128}, dtype=torch.bfloat16, device="cuda")


def _inputs(b, seed):
    rng = np.random.RandomState(seed)
    text = torch.from_numpy(rng.randint(2, 73, (b, 50))).cuda()
    return text, torch.from_numpy(rng.randn(b, 14, 1280).astype(np.float32)).cuda()


def _generate(model, text, style, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return generate(model, text, style, gen, seq_len=SEQ_LEN, n_steps=N_STEPS, device="cuda"), gen


def _eager(model, text, style, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.inference_mode():
        out = _sample(model, text, style, gen, SEQ_LEN, beta_table(N_STEPS, "strided", "cuda"),
                      "new", None, 1.0, None, None, torch.device("cuda"))
    return out, gen


def _counted(fn):
    tk.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, (tk.launches["fused_bottleneck"], tk.launches["fused_encoder_layer"],
                 tk.launches["fused_unet_t4"])


def _key(b):
    return SamplerGraphs.key(b, SEQ_LEN, n_steps=N_STEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("b, counts", [(8, (4, 8, 0)), (1, (4, 0, 0))])
def test_cuda_replay_matches_eager_with_the_kernels(model, b, counts):
    text, style = _inputs(b, seed=b)
    graphs = sampler_graphs(model)
    _generate(model, text, style, 3)  # eager
    _generate(model, text, style, 3)  # capture
    captures = graphs.captures
    (got, gen), launches = _counted(lambda: _generate(model, text, style, 3))
    (want, want_gen), eager_launches = _counted(lambda: _eager(model, text, style, 3))
    assert graphs.captures == captures  # the third call captures nothing
    assert torch.equal(got, want)
    assert torch.equal(gen.get_state(), want_gen.get_state())
    assert launches == eager_launches == counts
    assert graphs.info(_key(b))["launches"]["fused_bottleneck"] == N_STEPS


@pytest.mark.cuda
def test_cuda_replay_sees_weight_changes(model):
    """An in-place update is read by the next replay; replaced storage is
    captured again."""
    text, style = _inputs(8, seed=20)
    graphs = sampler_graphs(model)
    for _ in range(3):
        before, _ = _generate(model, text, style, 4)
    captures = graphs.captures
    weight = model.att_dense.weight  # read through the bottleneck kernel's tiles
    saved = weight.detach().clone()
    try:
        with torch.no_grad():
            weight.add_(1e-3)
        got, _ = _generate(model, text, style, 4)
        assert graphs.captures == captures
        assert torch.equal(got, _eager(model, text, style, 4)[0])
        assert not torch.equal(got, before)
        weight.data = weight.data.clone()
        got, _ = _generate(model, text, style, 4)
        assert graphs.captures == captures + 1
        assert torch.equal(got, _eager(model, text, style, 4)[0])
    finally:
        with torch.no_grad():
            weight.data = saved


@pytest.mark.cuda
def test_cuda_fused_t4_toggle_never_replays_the_other_graph(model, monkeypatch):
    text, style = _inputs(8, seed=30)
    graphs = sampler_graphs(model)
    for flag in ("0", "1"):
        monkeypatch.setenv("DHG_FUSED_T4", flag)
        _generate(model, text, style, 5)
        _generate(model, text, style, 5)
    captures = graphs.captures
    for flag, counts in (("0", (4, 8, 0)), ("1", (0, 0, 4)), ("0", (4, 8, 0))):
        monkeypatch.setenv("DHG_FUSED_T4", flag)
        (got, _), launches = _counted(lambda: _generate(model, text, style, 5))
        assert launches == counts
        assert torch.equal(got, _eager(model, text, style, 5)[0])
    assert graphs.captures == captures
    keys = [k for k in graphs._graphs if k.batch == 8 and k.text_len == 50]
    assert len({k.kernels for k in keys}) >= 2
