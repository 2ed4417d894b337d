"""A 5-step f32 training trajectory of the port against dhg's, on the CPU.

Both start from the same (transplanted) weights and take the same numpy
draws: batch rows, alpha_bar levels and fractions, noise. Dropout is off on
both sides (dhg: deterministic; the port: nn.Dropout patched out, as
tests/test_grad_accum.py patches flax's). dhg's side is its own model,
losses and optax chain (dhg.train.make_optimizer); the port's side is
Trainer.train_step. Bar: every step's loss within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch import nn

from dhg.config import DLConfig as JaxConfig
from dhg.core.losses import diffusion_loss
from dhg.core.schedule import get_alpha_set
from dhg.train import make_optimizer
from dhg_torch.config import DLConfig
from dhg_torch.train import Draws, Trainer
from dhg_torch.weights import state_dict_from_dhg
from test_torch_port_common import jax_model, random_params, t

C1, LAYERS, B, T_LEN, L_LEN, STEPS = 16, 1, 4, 16, 14, 5
CFG = {
    "experiment": {"seed": 0},
    "dataset_args": {"max_seq_len": T_LEN, "max_text_len": L_LEN},
    "training_args": {"channels": C1, "att_layers_num": LAYERS, "batch_size": B, "max_files": 8,
                      "warmup_steps": 20, "clip_grad": 100.0, "clip_mode": "norm",
                      "compute_dtype": "float32", "dataset": "synthetic"},
    "optimizer": {"type": "torch.optim.Adam",
                  "params": {"betas": [0.9, 0.98], "weight_decay": 1e-5}},
}


def trajectories():
    """(port losses, dhg losses) over STEPS steps from one transplanted
    init and shared draws. The caller patches nn.Dropout out."""
    params = random_params(seed=7, c1=C1, num_layers=LAYERS)
    trainer = Trainer(DLConfig(CFG), device="cpu")
    trainer.model.load_state_dict(state_dict_from_dhg(params), strict=True)
    data = trainer.load_dataset()

    jm, tx = jax_model(c1=C1, num_layers=LAYERS), make_optimizer(JaxConfig(CFG))
    alpha_set = get_alpha_set()

    @jax.jit
    def jax_step(p, opt_state, strokes3, text, style, a_idx, a_u, eps):
        x, pen = strokes3[..., :2], strokes3[..., 2]
        lower, upper = alpha_set[a_idx], alpha_set[a_idx + 1]
        alphas = a_u * (upper - lower) + lower
        xt = jnp.sqrt(alphas)[..., None] * x + jnp.sqrt(1.0 - alphas)[..., None] * eps

        def loss_fn(q):
            eps_pred, pen_pred = jm.apply({"params": q}, xt, text, jnp.sqrt(alphas), style)
            return diffusion_loss(eps, eps_pred, pen, pen_pred, alphas)[0]

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    p = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(p)
    rng = np.random.RandomState(11)
    arrays = [a.numpy() for a in data.arrays]
    ours, ref = [], []
    for _ in range(STEPS):
        idx = rng.randint(0, data.size, B)
        a_idx = rng.randint(0, 59, (B, 1))
        a_u = rng.rand(B, 1).astype(np.float32)
        eps = rng.randn(B, T_LEN, 2).astype(np.float32)
        batch = [jnp.asarray(a[idx]) for a in arrays]
        p, opt_state, loss = jax_step(p, opt_state, *batch, jnp.asarray(a_idx),
                                      jnp.asarray(a_u), jnp.asarray(eps))
        ref.append(float(loss))
        ours.append(float(trainer.train_step(Draws(t(idx), t(a_idx), t(a_u), t(eps)))[0]))
    return ours, ref


def test_five_step_loss_trajectory_matches_dhg(monkeypatch):
    monkeypatch.setattr(nn.Dropout, "forward", lambda self, x: x)
    ours, ref = trajectories()
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    assert len(set(ref)) == STEPS  # the steps moved the weights
