"""The port's schedule and step rules against dhg/core (pure float32 math)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.core import sampling as js
from dhg.core import schedule as jsch
from dhg_torch.core import sampling as ts
from dhg_torch.core import schedule as tsch


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def test_beta_and_alpha_sets():
    _close(tsch.get_beta_set().numpy(), jsch.get_beta_set())
    _close(tsch.get_alpha_set().numpy(), jsch.get_alpha_set())
    assert tsch.get_beta_set().dtype == torch.float32


@pytest.mark.parametrize("n_steps", [2, 15, 30, 59, 60])
def test_strided_beta_set(n_steps):
    _close(tsch.strided_beta_set(n_steps).numpy(), jsch.strided_beta_set(n_steps))


@pytest.mark.parametrize("n_steps", [60, 30, 15])
def test_halved_beta_set(n_steps):
    _close(tsch.halved_beta_set(n_steps).numpy(), jsch.halved_beta_set(n_steps))


@pytest.mark.parametrize("bad", [1, 61])
def test_strided_rejects_out_of_range(bad):
    with pytest.raises(ValueError):
        tsch.strided_beta_set(bad)


@pytest.mark.parametrize("bad", [7, 45])
def test_halved_rejects_unreachable(bad):
    with pytest.raises(ValueError):
        tsch.halved_beta_set(bad)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 24, 49])
def test_infer_seq_len(n):
    assert ts.infer_seq_len(n) == js.infer_seq_len(n)


def test_step_rules():
    rng = np.random.RandomState(0)
    x, eps, z = (rng.randn(3, 16, 2).astype(np.float32) for _ in range(3))
    tx, te, tz = (torch.from_numpy(a) for a in (x, eps, z))
    alpha_set = jsch.get_alpha_set()
    beta_set = jsch.get_beta_set()
    for i in (0, 1, 30, 59):
        a, b = alpha_set[i], beta_set[i]
        an = alpha_set[i - 1] if i > 1 else jnp.float32(1.0)
        ta, tb, tan = (torch.tensor(float(v)) for v in (a, b, an))
        _close(ts.new_diffusion_step(tx, te, tb, ta, tan, tz).numpy(),
               js.new_diffusion_step(x, eps, b, a, an, z))
        _close(ts.standard_diffusion_step(tx, te, tb, ta, tz, i > 0).numpy(),
               js.standard_diffusion_step(x, eps, b, a, z, i > 0))
        _close(ts.ddim_step(tx, te, ta, tan).numpy(), js.ddim_step(x, eps, a, an))
