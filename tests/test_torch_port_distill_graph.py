"""The distill step split for its CUDA graph (dhg_torch/distill.py), on the
CPU: host staging (Optimizer.stage) then the device-only body
(Distiller._step) is `Distiller.step` bit for bit, and `distill()` on the
CPU builds no graph and equals a loop of eager steps on its draws. The
replay itself runs on the card (test_torch_port_distill_eval_graph_cuda.py);
dhg parity stays with test_torch_port_distill.py.
"""

import logging

import torch

from dhg_torch import distill as distill_mod
from dhg_torch.config import DLConfig
from dhg_torch.data.pipeline import DeviceDataset, synthetic_cache
from dhg_torch.distill import Distiller
from dhg_torch.models.denoiser import DiffusionModel

torch.set_num_threads(1)

C1, B, T_LEN, L_LEN = 16, 4, 16, 14
CFG = {
    "experiment": {"seed": 2, "name": "teacher"},
    "dataset_args": {"max_seq_len": T_LEN, "max_text_len": L_LEN},
    "training_args": {"channels": C1, "att_layers_num": 1, "batch_size": B, "max_files": 8,
                      "warmup_steps": 20, "clip_grad": 100.0, "clip_mode": "norm",
                      "compute_dtype": "float32", "dataset": "synthetic"},
    "optimizer": {"type": "torch.optim.Adam",
                  "params": {"betas": [0.9, 0.98], "weight_decay": 1e-5}},
}


def _setup():
    """(two Distillers from one teacher, the data): the teacher is a seeded
    init, so the students start equal."""
    teacher = DiffusionModel.from_config(CFG["training_args"], device="cpu", seed=5).state_dict()
    data = DeviceDataset.from_cache(
        synthetic_cache(n=8, max_seq_len=T_LEN, max_text_len=L_LEN, seed=1), torch.device("cpu"))
    return [Distiller(DLConfig(CFG), teacher, device="cpu") for _ in range(2)], data


def _state(d):
    o = d.opt
    return [*(p.detach() for p in o.params), *o.mu, *o.nu]


def test_stage_and_body_equal_step():
    (a, b), data = _setup()
    gen = torch.Generator().manual_seed(3)
    rows_a, rows_b = [], []
    for _ in range(3):
        draws = a.draw(gen, data.size, T_LEN)
        rows_a.append(a.step(data.arrays, draws))
        b.opt.stage()
        rows_b.append(b._step(data.arrays, draws))
    assert torch.equal(torch.stack(rows_a), torch.stack(rows_b))
    assert torch.isfinite(torch.stack(rows_a)).all() and a.opt.count == b.opt.count == 3
    assert all(torch.equal(x, y) for x, y in zip(_state(a), _state(b)))
    # The updates moved the student off the teacher's copy.
    assert not all(torch.equal(x, y) for x, y in zip(a.student.parameters(),
                                                      a.teacher.parameters()))


def test_cpu_distill_builds_no_graph_and_equals_eager_steps(monkeypatch):
    (a, b), data = _setup()

    def refused(*args, **kwargs):
        raise AssertionError("a graph was built on the CPU")

    monkeypatch.setattr(distill_mod, "CapturedBody", refused)
    steps = 4
    got = a.distill(data, steps, logging.getLogger("test_distill_graph"), log_freq=2)
    assert a.graph is None
    # Today's loop: a fresh student, then `step` on draws from seed + 99.
    b.init_state()
    gen = torch.Generator().manual_seed(b.seed + 99)
    for _ in range(steps):
        b.step(data.arrays, b.draw(gen, data.size, T_LEN))
    want = b.student.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(x, y) for x, y in zip(_state(a), _state(b)))
    # make_step_fn on the CPU is `step` on the dataset's arrays.
    fn = a.make_step_fn(data)
    draws = a.draw(torch.Generator().manual_seed(4), data.size, T_LEN)
    assert torch.equal(fn(draws), b.step(data.arrays, draws)) and a.graph is None
