"""The port's line sampler against dhg's generate in float32.

Both sides get the same weights (the bridge) and the same randomness: the
test redraws exactly what dhg's diffusion_sample draws from its key
(dhg/core/sampling.py: split(key) -> x_T from the first half, one normal per
step from split(second half, n)) and hands those arrays to the port as
x_init / noises. Bar: stroke MSE within 1e-3 (ARCHITECTURE.md's sampler bar).
"""

import jax
import numpy as np
import pytest
import torch

from dhg.inference import generate as jax_generate
from dhg_torch.inference import generate, sample_lines
from test_torch_port_common import inputs, jax_model, port_model, random_params

SEQ_LEN = 16
C1, N_LAYERS = 16, 1  # small: each case's cost is dhg's sampler compile


@pytest.fixture(scope="module")
def ctx():
    params = random_params(seed=6, c1=C1, num_layers=N_LAYERS)
    _, text, _, style = inputs(batch=2, seq_len=SEQ_LEN, text_len=5, seed=7)
    return (params, jax_model(c1=C1, num_layers=N_LAYERS),
            port_model(params, c1=C1, num_layers=N_LAYERS), text, style)


def _draws(key, batch, n):
    """The x_T and per-step noise dhg's diffusion_sample draws from `key`."""
    k_init, k_steps = jax.random.split(key)
    x0 = jax.random.normal(k_init, (batch, SEQ_LEN, 2))
    noises = jax.vmap(lambda k: jax.random.normal(k, (batch, SEQ_LEN, 2)))(
        jax.random.split(k_steps, n)
    )
    return torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(noises))


@pytest.mark.parametrize(
    "mode,guidance,temperature,n_steps",
    [
        ("new", None, None, None),
        ("standard", None, None, None),
        ("ddim", None, None, None),
        ("new", 2.0, 0.8, None),
        ("ddim", None, None, 15),
    ],
)
def test_sampler_matches_dhg(ctx, mode, guidance, temperature, n_steps):
    params, jm, pm, text, style = ctx
    key = jax.random.PRNGKey(11)
    ref = jax_generate(jm, params, text, style, key, seq_len=SEQ_LEN, diffusion_mode=mode,
                       guidance_scale=guidance, n_steps=n_steps, temperature=temperature)
    x0, noises = _draws(key, text.shape[0], n_steps or 60)
    out = generate(pm, text, style, seq_len=SEQ_LEN, diffusion_mode=mode,
                   guidance_scale=guidance, n_steps=n_steps, temperature=temperature,
                   x_init=x0, noises=noises, device="cpu")
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, SEQ_LEN, 3) and out.dtype == torch.float32
    mse = float(np.mean((out.numpy() - ref) ** 2))
    assert mse < 1e-3, mse


def test_generator_draws_are_reproducible(ctx):
    _, _, pm, text, style = ctx
    runs = [
        generate(pm, text, style, torch.Generator().manual_seed(s), seq_len=SEQ_LEN, n_steps=3,
                 device="cpu")
        for s in (0, 0, 1)
    ]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all()


@pytest.mark.parametrize("prompts", [["Hello, World!"], ["a", "", "tab\tand \u00e9 \u4e2d 9?"]])
def test_tokenizer_matches_dhg(prompts):
    from dhg.data.tokenizer import Tokenizer as JaxTokenizer
    from dhg_torch.data.tokenizer import Tokenizer

    ours, ref = Tokenizer(), JaxTokenizer()
    assert ours.vocab_size == ref.vocab_size == 73
    np.testing.assert_array_equal(ours.encode_batch(prompts, 32), ref.encode_batch(prompts, 32))
    assert all(ours.encode(p) == ref.encode(p) for p in prompts)
    with pytest.raises(ValueError):
        ours.encode_batch(["x" * 32], 32)


def test_sample_lines_trims_each_line(ctx):
    _, _, pm, _, style = ctx
    lines = sample_lines(pm, ["hi", "hello there"], style[:1], torch.Generator().manual_seed(0),
                         n_steps=2, device="cpu")
    assert [a.shape for a in lines] == [(56, 3), (200, 3)]
    assert all(np.isfinite(a).all() for a in lines)
