"""The port's opt-in samplers against dhg's, in float32 on the CPU: the full
hoist (generate(hoist="full")), encoder reuse
(core/sampling.py::diffusion_sample_encoder_reuse through
generate(encoder_reuse=k)) and Jacobi parallel DDIM
(core/parallel_sampling.py).

Both sides get the same weights (the bridge) and the same randomness: each
test redraws what dhg draws from its key and hands it to the port. The bars
are dhg's own tests' (tests/test_kv_hoist.py, test_encoder_reuse.py,
test_parallel_sampling.py): the port's full hoist equals its compact hoist
bit for bit; port against dhg within 1e-3 stroke MSE (the sampler bar);
Jacobi at sweeps = n within 2e-9 stroke MSE of the sequential DDIM
sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.core.parallel_sampling import parallel_ddim_sample as jax_parallel_ddim
from dhg.core.schedule import strided_beta_set as jax_strided_beta_set
from dhg.inference import generate as jax_generate
from dhg_torch.core.parallel_sampling import parallel_ddim_sample
from dhg_torch.core.sampling import diffusion_sample
from dhg_torch.core.schedule import strided_beta_set
from dhg_torch.inference import _sample, beta_table, generate
from dhg_torch.ops.basic import create_padding_mask
from test_torch_port_common import inputs, jax_model, port_model, random_params, t

SEQ_LEN = 16
C1, N_LAYERS = 16, 1  # small: dhg's side is one sampler compile a function
JACOBI_N = 8  # Jacobi's strided schedule: 8 levels, batch 8 * B a sweep
BAR = 1e-3  # stroke MSE, port against dhg


def make_ctx():
    """(dhg params, dhg model, port model, text, style) of the small model."""
    params = random_params(seed=8, c1=C1, num_layers=N_LAYERS)
    _, text, _, style = inputs(batch=2, seq_len=SEQ_LEN, text_len=5, seed=9)
    return (params, jax_model(c1=C1, num_layers=N_LAYERS),
            port_model(params, c1=C1, num_layers=N_LAYERS), text, style)


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


def _draws(key, batch, n):
    """The x_T and per-step noise dhg draws from `key` in diffusion_sample
    and in diffusion_sample_encoder_reuse (dhg/core/sampling.py): split(key)
    -> x_T from the first half, one normal a step from split(second, n)."""
    k_init, k_steps = jax.random.split(key)
    x0 = jax.random.normal(k_init, (batch, SEQ_LEN, 2))
    noises = jax.vmap(lambda k: jax.random.normal(k, (batch, SEQ_LEN, 2)))(
        jax.random.split(k_steps, n))
    return torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(noises))


def _stroke_mse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean((a[..., :2] - b[..., :2]) ** 2))


def _port(pm, text, style, **kw):
    return generate(pm, text, style, seq_len=SEQ_LEN, device="cpu", **kw)


# -- full hoist ----------------------------------------------------------------


@pytest.mark.parametrize("guidance", [None, 2.0])
def test_full_hoist_equals_compact_bit_for_bit(ctx, guidance):
    """Bar: equal bit for bit (the full hoist builds its K/V with the calls
    the compact loop makes)."""
    _, _, pm, text, style = ctx
    runs = {hoist: _port(pm, text, style, generator=torch.Generator().manual_seed(3),
                         guidance_scale=guidance, hoist=hoist)
            for hoist in (None, "compact", "full")}
    assert torch.equal(runs[None], runs["compact"])
    assert torch.equal(runs["full"], runs["compact"])
    assert torch.isfinite(runs["full"]).all()


def dhg_full_of(ctx):
    """dhg's generate(hoist="full") and its key."""
    params, jm, _, text, style = ctx
    key = jax.random.PRNGKey(11)
    return key, np.asarray(jax.block_until_ready(
        jax_generate(jm, params, text, style, key, seq_len=SEQ_LEN, hoist="full")))


@pytest.fixture(scope="module")
def dhg_full(ctx):
    return dhg_full_of(ctx)


def port_on_dhg_draws(ctx, key, **kw):
    _, _, pm, text, style = ctx
    x0, noises = _draws(key, 2, 60)
    return _port(pm, text, style, x_init=x0, noises=noises, **kw)


def test_full_hoist_matches_dhg(ctx, dhg_full):
    """Bar: stroke MSE <= 1e-3 against dhg's generate(hoist="full")."""
    key, ref = dhg_full
    out = port_on_dhg_draws(ctx, key, hoist="full")
    assert out.shape == ref.shape == (2, SEQ_LEN, 3)
    assert _stroke_mse(out.numpy(), ref) <= BAR


def test_hoist_names_are_checked(ctx):
    _, _, pm, text, style = ctx
    with pytest.raises(ValueError, match="hoist must be"):
        _port(pm, text, style, hoist="half", n_steps=2)


# -- encoder reuse -------------------------------------------------------------


def test_split_encode_decode_equals_denoise(ctx):
    """Bar: equal bit for bit (denoise is encode_unet then decode_unet)."""
    _, _, pm, text, style = ctx
    x, _, sigma, _ = inputs(batch=2, seq_len=SEQ_LEN, text_len=5, seed=4)
    x, text, sigma, style = t(x), t(text), t(sigma), t(style)
    with torch.inference_mode():
        se = pm.embed_sigma(sigma)
        cond = pm.encode_cond(text, style, se)
        mask = create_padding_mask(text)
        eps1, pen1 = pm.denoise(x, cond, se, mask)
        eps2, pen2 = pm.decode_unet(pm.encode_unet(x, cond, se, mask), cond, se, mask)
    assert torch.equal(eps1, eps2) and torch.equal(pen1, pen2)


def test_reuse_every_one_is_the_exact_sampler(ctx):
    """Bar: equal bit for bit. generate(encoder_reuse=1) runs the normal
    sampler, as dhg's; the reuse sampler itself at reuse_every=1 (on the full
    hoist) equals the compact sampler."""
    _, _, pm, text, style = ctx
    want = _port(pm, text, style, generator=torch.Generator().manual_seed(5))
    got = _port(pm, text, style, generator=torch.Generator().manual_seed(5), encoder_reuse=1)
    assert torch.equal(got, want)
    tt, ss = torch.as_tensor(text, dtype=torch.long), torch.as_tensor(style)
    with torch.inference_mode():
        direct = _sample(pm, tt, ss, torch.Generator().manual_seed(5), SEQ_LEN,
                         beta_table(60, "strided", "cpu"), "new", None, 1.0, None, None,
                         torch.device("cpu"), encoder_reuse=1)
    assert torch.equal(direct, want)


def dhg_reuse_of(ctx):
    """dhg's generate(encoder_reuse=2) and its key."""
    params, jm, _, text, style = ctx
    key = jax.random.PRNGKey(3)
    return key, np.asarray(jax.block_until_ready(
        jax_generate(jm, params, text, style, key, seq_len=SEQ_LEN, encoder_reuse=2)))


@pytest.fixture(scope="module")
def dhg_reuse(ctx):
    return dhg_reuse_of(ctx)


def test_reuse_two_matches_dhg(ctx, dhg_reuse):
    """Bar: stroke MSE <= 1e-3 against dhg's generate(encoder_reuse=2) on
    dhg's own draws; and reuse 2 is not the exact sampler."""
    key, ref = dhg_reuse
    out = port_on_dhg_draws(ctx, key, encoder_reuse=2)
    exact = port_on_dhg_draws(ctx, key)
    assert np.isfinite(out.numpy()).all()
    assert _stroke_mse(out.numpy(), ref) <= BAR
    assert not np.allclose(out[..., :2].numpy(), exact[..., :2].numpy())


@pytest.mark.parametrize("kw,match", [
    ({"guidance_scale": 2.0}, "mutually exclusive"),
    ({"temperature": 0.7}, "neither a temperature nor sample_seeds"),
    ({"sample_seeds": [1, 2]}, "neither a temperature nor sample_seeds"),
])
def test_reuse_refuses_what_dhg_ignores_or_forbids(ctx, kw, match):
    _, _, pm, text, style = ctx
    with pytest.raises(ValueError, match=match):
        _port(pm, text, style, encoder_reuse=2, n_steps=2, **kw)


# -- Jacobi parallel DDIM ------------------------------------------------------


def _denoisers(pm, text, style):
    text, style = t(text), t(style)
    b = text.shape[0]

    def sequential(x, sigma, step):  # batch B, one call a step
        return pm(x, text, sigma, style)

    def tiled(x, sigma):  # batch n * B, the conditioning tiled
        reps = x.shape[0] // b
        return pm(x, text.repeat(reps, 1), sigma, style.repeat(reps, 1, 1))

    return sequential, tiled


def test_jacobi_full_sweeps_equal_sequential_ddim(ctx):
    """Bar: sweeps = n within 2e-9 stroke MSE of the sequential DDIM sampler
    (dhg's), both drawing x_T from one generator seed."""
    _, _, pm, text, style = ctx
    sequential, tiled = _denoisers(pm, text, style)
    beta = strided_beta_set(6)
    with torch.inference_mode():
        seq = diffusion_sample(sequential, 2, SEQ_LEN, beta, mode="ddim",
                               generator=torch.Generator().manual_seed(7), device="cpu")
    par = parallel_ddim_sample(tiled, 2, SEQ_LEN, beta, generator=torch.Generator().manual_seed(7),
                               device="cpu")
    assert par.shape == (2, SEQ_LEN, 3)
    assert _stroke_mse(par.numpy(), seq.numpy()) <= 2e-9


def jacobi_of(ctx):
    """dhg's parallel_ddim_sample(return_all_sweeps=True) under one jit, its
    x_T, and the port's sequential DDIM trajectory from that x_T."""
    params, jm, pm, text, style = ctx
    b = text.shape[0]

    def denoise_any(x, sigma):
        reps = x.shape[0] // b
        return jm.apply({"params": params}, x, jnp.tile(text, (reps, 1)), sigma,
                        jnp.tile(style, (reps, 1, 1)))

    key = jax.random.PRNGKey(13)
    _, ests = jax.block_until_ready(jax.jit(lambda k: jax_parallel_ddim(
        denoise_any, k, batch_size=b, seq_len=SEQ_LEN, beta_set=jax_strided_beta_set(JACOBI_N),
        return_all_sweeps=True))(key))
    x_t, _ = _draws(key, b, 1)  # x_T is split(key)[0]'s draw, as diffusion_sample's
    sequential, _ = _denoisers(pm, text, style)
    with torch.inference_mode():
        seq = diffusion_sample(sequential, b, SEQ_LEN, strided_beta_set(JACOBI_N), mode="ddim",
                               x_init=x_t, noises=torch.zeros((JACOBI_N, b, SEQ_LEN, 2)),
                               device="cpu")
    return x_t, np.asarray(ests), seq.numpy()


@pytest.fixture(scope="module")
def jacobi(ctx):
    return jacobi_of(ctx)


def port_jacobi(ctx, x_t):
    """The port's every-sweep estimates [n, B, T, 3] from x_T."""
    _, _, pm, text, style = ctx
    _, tiled = _denoisers(pm, text, style)
    return parallel_ddim_sample(tiled, 2, SEQ_LEN, strided_beta_set(JACOBI_N), x_init=x_t,
                                return_all_sweeps=True, device="cpu")


def test_jacobi_converges_to_sequential_ddim(ctx, jacobi):
    """dhg's convergence bars: the last sweep within 2e-9 of the fixed
    point, sweep 3 better than sweep 1, the last sweep the best."""
    x_t, _, seq = jacobi
    out, ests = port_jacobi(ctx, x_t)
    assert ests.shape == (JACOBI_N, 2, SEQ_LEN, 3) and torch.equal(out, ests[-1])
    errs = [_stroke_mse(e, seq) for e in ests.numpy()]
    assert errs[-1] <= 2e-9
    assert errs[2] < errs[0]
    assert errs[-1] <= min(errs) + 1e-12


def test_jacobi_matches_dhg_each_sweep(ctx, jacobi):
    """Bar: every sweep's estimate within 1e-3 stroke MSE of dhg's on the
    same x_T."""
    x_t, ref, _ = jacobi
    _, ests = port_jacobi(ctx, x_t)
    assert ests.shape == ref.shape
    for k, (got, want) in enumerate(zip(ests.numpy(), ref)):
        assert _stroke_mse(got, want) <= BAR, k
