"""The port's training pieces against dhg's, on the CPU: losses (values and
gradients, a saturated pen head included), the optimizer chain against
dhg's optax chain, the Noam schedule, the synthetic cache, alpha_bar draws,
stroke augmentation, and grad_accum against the unsplit step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from dhg.config import DLConfig as JaxConfig
from dhg.core import losses as jl
from dhg.core.schedule import get_alpha_set as jax_alpha_set, sample_alphas as jax_sample_alphas
from dhg.data import pipeline as jp
from dhg.train import make_optimizer as jax_make_optimizer, noam_schedule as jax_noam
from dhg_torch.config import DLConfig
from dhg_torch.core import losses as tl
from dhg_torch.core.schedule import alphas_from_draws, get_alpha_set, sample_alphas
from dhg_torch.data import pipeline as tp
from dhg_torch.train import Draws, Trainer, make_optimizer, noam_schedule
from test_torch_port_common import f32, t


def test_losses_match_dhg_values_and_grads():
    rng = np.random.RandomState(0)
    b, n = 3, 10
    eps, eps_pred = rng.randn(2, b, n, 2).astype(np.float32)
    pen = (rng.rand(b, n) < 0.3).astype(np.float32)
    pen_pred = rng.uniform(0.01, 0.99, (b, n)).astype(np.float32)
    pen_pred[0, :4] = [0.0, 1.0, 1e-30, 1.0 - 1e-7]  # a saturated head
    pen[0, :4] = [1.0, 0.0, 1.0, 0.0]
    alphas = rng.uniform(0.1, 1.0, (b, 1)).astype(np.float32)

    def jax_total(ep, pp):
        return jl.diffusion_loss(jnp.asarray(eps), ep, jnp.asarray(pen), pp, jnp.asarray(alphas))

    want, vjp = jax.vjp(jax_total, jnp.asarray(eps_pred), jnp.asarray(pen_pred))
    want_grads = vjp((jnp.float32(1.0), jnp.float32(0.5), jnp.float32(2.0)))

    ep, pp = t(eps_pred).requires_grad_(True), t(pen_pred).requires_grad_(True)
    got = tl.diffusion_loss(t(eps), ep, t(pen), pp, t(alphas))
    (got[0] + 0.5 * got[1] + 2.0 * got[2]).backward()
    np.testing.assert_allclose([float(v.detach()) for v in got], [float(v) for v in want], rtol=1e-6)
    np.testing.assert_allclose(f32(ep.grad), f32(want_grads[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(f32(pp.grad), f32(want_grads[1]), rtol=1e-5)
    assert np.abs(f32(pp.grad)).max() > 1e9  # the saturated head still gets a push


class Tiny(nn.Module):
    """One parameter of every AGC rule: Linear, Linear with a unit output
    and a unit input (vectors after squeeze), Conv1d, Embedding, biases."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.lin = nn.Linear(5, 4)
        self.head = nn.Linear(4, 1)
        self.inp = nn.Linear(1, 6)
        self.conv = nn.Conv1d(3, 4, 3)
        self.emb = nn.Embedding(7, 4)


def _to_dhg(tree: dict) -> dict:
    """Tiny's tensors (torch layout) -> dhg's layout, numpy."""
    out = {}
    for key, v in tree.items():
        mod, name = key.split(".")
        a = v.detach().numpy() if isinstance(v, torch.Tensor) else v
        if name == "weight":
            name = "embedding" if mod == "emb" else "kernel"
            a = a.transpose(2, 1, 0) if mod == "conv" else (a if mod == "emb" else a.T)
        out.setdefault(mod, {})[name] = np.array(a)  # a copy: jax may alias numpy memory
    return out


@pytest.mark.parametrize("kind,clip_mode,clip,lr_override", [
    ("adam", "norm", 0.5, None), ("adam", "value", 0.3, None), ("adam", "agc", 0.05, None),
    ("adamw", "norm", 0.5, None), ("adam", None, None, 1e-3)])
def test_optimizer_matches_optax_chain(kind, clip_mode, clip, lr_override):
    types = {"adam": "torch.optim.Adam", "adamw": "torch.optim.AdamW"}
    cfg = {"training_args": {"channels": 16, "warmup_steps": 10, "clip_grad": clip,
                             "clip_mode": clip_mode},
           "optimizer": {"type": types[kind],
                         "params": {"betas": [0.9, 0.98], "weight_decay": 0.01}}}
    model = Tiny()
    opt = make_optimizer(DLConfig(cfg), model, lr_override=lr_override)
    tx = jax_make_optimizer(JaxConfig(cfg), lr_override=lr_override)
    params = jax.tree.map(jnp.asarray, _to_dhg(dict(model.named_parameters())))
    state = tx.init(params)
    rng = np.random.RandomState(1)
    for _ in range(5):
        grads = {k: rng.randn(*p.shape).astype(np.float32) for k, p in model.named_parameters()}
        opt.step([torch.from_numpy(grads[n].copy()) for n in opt.names])
        updates, state = tx.update(jax.tree.map(jnp.asarray, _to_dhg(grads)), state, params)
        params = optax.apply_updates(params, updates)
        want = jax.tree.leaves(params)
        got = jax.tree.leaves(_to_dhg(dict(model.named_parameters())))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def test_noam_schedule_matches_dhg():
    ours, ref = noam_schedule(256, 10000), jax_noam(256, 10000)
    for count in (0, 1, 5, 9999, 10000, 60000):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-7)


def test_synthetic_cache_is_dhgs():
    ours, ref = tp.synthetic_cache(5, 16, 14, seed=3), jp.synthetic_cache(5, 16, 14, seed=3)
    for name in ("strokes", "text", "style"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    assert ours.sample_ids == ref.sample_ids and len(ours) == 5


def test_alpha_draws_match_dhg():
    key = jax.random.PRNGKey(4)
    ref = jax_sample_alphas(key, 16, jax_alpha_set())
    k_idx, k_u = jax.random.split(key)
    idx = jax.random.randint(k_idx, (16, 1), 0, 59)
    u = jax.random.uniform(k_u, (16, 1))
    ours = alphas_from_draws(t(idx), t(u), get_alpha_set())
    np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-6, atol=1e-7)
    drawn = sample_alphas(torch.Generator().manual_seed(0), 512, get_alpha_set())
    assert drawn.shape == (512, 1)
    assert float(drawn.min()) >= float(get_alpha_set()[-1]) and float(drawn.max()) <= float(get_alpha_set()[0])


def test_augmentation_matches_dhg():
    key, knobs = jax.random.PRNGKey(5), {"scale": 0.1, "rotate": 0.2, "shear": 0.05}
    strokes = np.random.RandomState(6).randn(4, 8, 3).astype(np.float32)
    ref = jp.augment_strokes(key, jnp.asarray(strokes), **knobs)
    u = jnp.stack([jax.random.uniform(k, (4,)) for k in jax.random.split(key, 3)])
    ours = tp.augment_strokes(tp.augment_matrices(t(u), **knobs), t(strokes))
    np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5, atol=1e-6)
    eye = tp.augment_matrices(torch.rand(3, 4))
    torch.testing.assert_close(eye, torch.eye(2).expand(4, 2, 2))


def test_dropout_is_live_in_training_only():
    """The style dropout 0.3 acts in every training forward; drop_rate acts
    in the ConvBlocks and EncoderLayers; eval is deterministic."""
    from dhg_torch.models.denoiser import DiffusionModel

    strokes, text, sigma, style = (torch.from_numpy(a) for a in (
        np.random.RandomState(0).randn(2, 16, 2).astype(np.float32), np.array([[5, 6, 1, 0]] * 2),
        np.full((2, 1), 0.5, np.float32), np.random.RandomState(1).randn(2, 14, 1280).astype(np.float32)))
    for drop_rate in (0.0, 0.5):
        model = DiffusionModel.from_config({"channels": 16, "att_layers_num": 1, "dropout": drop_rate},
                                           device="cpu")
        with torch.no_grad():
            a, b = model(strokes, text, sigma, style)[0], model(strokes, text, sigma, style)[0]
            assert torch.equal(a, b)  # from_config returns an eval model
            model.train()
            c, d = model(strokes, text, sigma, style)[0], model(strokes, text, sigma, style)[0]
            assert not torch.equal(c, d) and not torch.equal(c, a)
            x = torch.randn(2, 16, 16)  # a ConvBlock alone: live only with drop_rate > 0
            e, f = model.enc1(x, torch.zeros(2, 4)), model.enc1(x, torch.zeros(2, 4))
            assert torch.equal(e, f) == (drop_rate == 0.0)


def _trainer(accum):
    return Trainer(DLConfig({
        "experiment": {"seed": 0},
        "dataset_args": {"max_seq_len": 32, "max_text_len": 14},
        "training_args": {"channels": 16, "att_layers_num": 1, "batch_size": 4,
                          "max_files": 8, "warmup_steps": 20, "clip_grad": 1.0,
                          "compute_dtype": "float32", "dataset": "synthetic", "grad_accum": accum},
        "optimizer": {"type": "torch.optim.Adam",
                      "params": {"betas": [0.9, 0.98], "weight_decay": 1e-5}},
    }), device="cpu")


def test_grad_accum_matches_unsplit_step(monkeypatch):
    monkeypatch.setattr(nn.Dropout, "forward", lambda self, x: x)
    ref, acc = _trainer(1), _trainer(2)
    d = ref.draw(3)
    m_ref, m_acc = ref.train_step(d), acc.train_step(Draws(*d))
    np.testing.assert_allclose(f32(m_acc), f32(m_ref), rtol=1e-5, atol=1e-6)
    for a, b in zip(acc.opt.params, ref.opt.params):
        np.testing.assert_allclose(f32(a), f32(b), rtol=2e-4, atol=1e-6)
    with pytest.raises(ValueError, match="grad_accum"):
        _trainer(3)


def test_eval_batch_matches_dhg():
    """dhg_torch/eval.py::eval_batch against dhg's make_eval_fn (the val_freq
    pass) on the f32 C1 = 32 model, B = 3, T = 16: the same eps (dhg's draw
    from its key, handed to the port), equal within 1e-6."""
    from dhg.eval import make_eval_fn
    from dhg_torch.eval import eval_batch, eval_levels
    from test_torch_port_common import inputs, jax_model, port_model, random_params

    params = random_params(seed=3)
    strokes, text, _, style = inputs(batch=3, seq_len=16, text_len=6, seed=5)
    pen = (np.random.RandomState(6).rand(3, 16) < 0.3).astype(np.float32)
    strokes3 = np.concatenate([strokes, pen[..., None]], axis=-1)
    key = jax.random.PRNGKey(7)
    want = jax.block_until_ready(make_eval_fn(jax_model())(params, strokes3, text, style, key))
    eps = np.asarray(jax.random.normal(key, strokes.shape))
    got = eval_batch(port_model(params), t(strokes3), t(text), t(style), t(eps), eval_levels())
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-6, atol=1e-6)
