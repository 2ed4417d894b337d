"""The port's progressive distillation step (dhg_torch/distill.py) against
dhg's, on the CPU in f32 (the probe and the CLIs:
test_torch_port_distill_probe.py).

Both sides get the same transplanted weights (C1 = 16, one attention
layer) and the same data (the port's synthetic cache, B = 4, T = 16).
dhg's step is its own `Distiller._build_step()` under one jax.jit; the
port's step gets the draws dhg makes from each key, split as `_build_step`
splits it (batch rows, student step index, noise). dhg's model.init is
never compiled.

The relative bars run from a student that is not the teacher's copy (a
second transplanted init, which dhg's step takes as its state): at the
copy, the loss is the teacher's own one-step-against-two-steps gap, ~1e-6,
a difference of nearly equal float32 numbers, so a relative bar there
measures rounding. There the bar is absolute (1e-9). Bars: the first loss
triple within 1e-5 relative, a 3-step trajectory within 1e-4 (the
train-parity bar), the student's parameters within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg.config import DLConfig as JaxConfig
from dhg.distill import Distiller as JaxDistiller
from dhg_torch.config import DLConfig
from dhg_torch.core.schedule import get_alpha_set, halved_beta_set
from dhg_torch.data.pipeline import DeviceDataset, synthetic_cache
from dhg_torch.distill import Distiller, DistillDraws
from dhg_torch.weights import state_dict_from_dhg
from test_torch_port_common import random_params

C1, LAYERS, B, T_LEN, L_LEN = 16, 1, 4, 16, 14
LR = 1e-4  # dhg's --lr: a constant learning rate
CFG = {
    "experiment": {"seed": 0, "name": "teacher"},
    "dataset_args": {"max_seq_len": T_LEN, "max_text_len": L_LEN},
    "training_args": {"channels": C1, "att_layers_num": LAYERS, "batch_size": B, "max_files": 8,
                      "warmup_steps": 20, "clip_grad": 100.0, "clip_mode": "norm",
                      "compute_dtype": "float32", "dataset": "synthetic"},
    "optimizer": {"type": "torch.optim.Adam",
                  "params": {"betas": [0.9, 0.98], "weight_decay": 1e-5}},
}


def _cfg(**ta):
    cfg = copy.deepcopy(CFG)
    cfg["training_args"].update(ta)
    return cfg


@pytest.fixture(scope="module")
def ctx():
    """(teacher params, data, dhg's Distiller, its jitted step, dhg's arrays)."""
    params = random_params(seed=8, c1=C1, num_layers=LAYERS)
    cache = synthetic_cache(n=8, max_seq_len=T_LEN, max_text_len=L_LEN, seed=0)
    data = DeviceDataset.from_cache(cache, torch.device("cpu"))
    jd = JaxDistiller(JaxConfig(CFG), jax.tree.map(jnp.asarray, params), lr=LR)
    jstep = jax.jit(jd._build_step())
    arrays = (jnp.asarray(cache.strokes, jnp.float32), jnp.asarray(cache.text, jnp.int32),
              jnp.asarray(cache.style, jnp.float32))
    return params, data, jd, jstep, arrays


def _draws(key, jd, n_rows):
    """The draws dhg's step makes from `key`, as DistillDraws."""
    k_batch, k_idx, k_eps = jax.random.split(key, 3)
    idx = jax.random.randint(k_batch, (B,), 0, n_rows)
    i = jax.random.randint(k_idx, (B, 1), 0, jd.student_steps)
    eps = jax.random.normal(k_eps, (B, T_LEN, 2))
    return DistillDraws(torch.from_numpy(np.array(idx, np.int64)),
                        torch.from_numpy(np.array(i, np.int64)), torch.from_numpy(np.array(eps)))


def _run(ctx, student_params, steps):
    """(port loss triples, dhg loss triples, the port's Distiller, dhg's
    student params) after `steps` steps from `student_params` (None: the
    teacher's copy)."""
    from dhg.train import TrainState

    params, data, jd, jstep, arrays = ctx
    d = Distiller(DLConfig(CFG), state_dict_from_dhg(params), lr=LR, device="cpu")
    if student_params is None:  # dhg's init_state: a copy of the teacher
        student_params = params
    else:
        d.student.load_state_dict(state_dict_from_dhg(student_params), strict=True)
    p = jax.tree.map(jnp.array, student_params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p,
                       opt_state=jax.jit(jd.tx.init)(p))
    ours, ref = [], []
    for c in range(1, steps + 1):
        key = jax.random.fold_in(jax.random.PRNGKey(99), c)
        state, metrics = jstep(state, key, arrays, jd.teacher_params)
        ref.append(np.asarray(metrics).tolist())
        ours.append(d.step(data.arrays, _draws(key, jd, data.size)).tolist())
    return ours, ref, d, state.params


@pytest.fixture(scope="module")
def trajectory(ctx):
    """3 steps from a student other than the teacher's copy."""
    return _run(ctx, random_params(seed=9, c1=C1, num_layers=LAYERS), 3)


@pytest.mark.parametrize("teacher_steps", [60, 30])
def test_grid_tables_match_dhg(ctx, teacher_steps):
    params, *_ = ctx
    ta = {} if teacher_steps == 60 else {"distilled_steps": teacher_steps}
    jd = JaxDistiller(JaxConfig(_cfg(**ta)), params)
    d = Distiller(DLConfig(_cfg(**ta)), state_dict_from_dhg(params), device="cpu")
    assert (d.teacher_steps, d.student_steps) == (jd.teacher_steps, jd.student_steps)
    teacher, student = d.teacher.state_dict(), d.student.state_dict()
    assert all(torch.equal(student[k], t) and student[k] is not t for k, t in teacher.items())
    # The port's levels are exactly its own table's entries at dhg's indices ...
    abar = get_alpha_set(halved_beta_set(teacher_steps))
    k = teacher_steps // 2
    assert torch.equal(d.a_in, abar[1::2]) and torch.equal(d.a_mid, abar[0::2])
    assert torch.equal(d.a_out, torch.cat([torch.ones(1), abar[1::2][: k - 1]]))
    # ... and dhg's within the schedule bar (the two cumprods sum in another order).
    for ours, theirs in ((d.a_in, jd.a_in), (d.a_mid, jd.a_mid), (d.a_out, jd.a_out)):
        assert ours.shape == theirs.shape == (k,)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ta,student_steps", [({}, 20), ({"distilled_steps": 15}, None),
                                              ({"distilled_steps": 30}, 10)])
def test_bad_student_steps_raise_as_in_dhg(ctx, ta, student_steps):
    params, *_ = ctx
    with pytest.raises(ValueError) as want:
        JaxDistiller(JaxConfig(_cfg(**ta)), params, student_steps=student_steps)
    with pytest.raises(ValueError) as got:
        Distiller(DLConfig(_cfg(**ta)), state_dict_from_dhg(params),
                  student_steps=student_steps, device="cpu")
    assert str(got.value) == str(want.value)


def test_first_step_matches_dhg(trajectory):
    ours, ref, *_ = trajectory
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    assert all(np.isfinite(ours[0])) and ours[0][1] > 1e-3


def test_first_step_from_the_copy_matches_dhg(ctx):
    ours, ref, d, _ = _run(ctx, None, 1)
    assert ours[0][0] < 1e-4  # the student starts as the teacher
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=1e-9)


def test_three_steps_and_student_match_dhg(trajectory):
    ours, ref, d, jparams = trajectory
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    want = state_dict_from_dhg(jax.tree.map(np.asarray, jparams))
    got = d.student.state_dict()
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert all(not p.requires_grad for p in d.teacher.parameters())
    assert not d.student.training  # dropout off while gradients are recorded
