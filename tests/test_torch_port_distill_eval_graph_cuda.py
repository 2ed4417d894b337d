"""The distill step and the eval step on the card (marker `cuda`; skipped
without one), at a narrow width: Distiller.make_step_fn's replayed step
against eager `Distiller.step` on the same draws, bit for bit (student
params, Adam moments, rows) with the train kernels off and on, f32 and
bf16, and their launch counts equal; make_eval_fn's replayed batches
against eager `eval_batch` over a cache with a tail (two keys, two
captures), an in-place weight update read by the next replay, and a
replaced storage captured again. No JAX here, so it runs where the card
is:
    python -m pytest --noconftest -m cuda tests/test_torch_port_distill_eval_graph_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dhg_torch.config import DLConfig
from dhg_torch.data.pipeline import DeviceDataset, synthetic_cache
from dhg_torch.distill import Distiller
from dhg_torch.eval import EvalGraphs, eval_batch, eval_levels, evaluate, make_eval_fn
from dhg_torch.kernels.runtime import launch_counts
from dhg_torch.models.denoiser import DiffusionModel

T_LEN, L_LEN = 64, 14


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(dtype):
    return DLConfig({
        "experiment": {"seed": 3, "name": "teacher"},
        "dataset_args": {"max_seq_len": T_LEN, "max_text_len": L_LEN},
        "training_args": {"channels": 32, "att_layers_num": 2, "batch_size": 8, "max_files": 16,
                          "warmup_steps": 20, "clip_grad": 100.0, "clip_mode": "norm",
                          "compute_dtype": dtype, "dataset": "synthetic"},
        "optimizer": {"type": "torch.optim.Adam",
                      "params": {"weight_decay": 1e-5, "betas": [0.9, 0.98]}},
    })


def _flags(monkeypatch, on):
    for name in ("DHG_FUSED_ATTENTION", "DHG_FUSED_CONVBLOCK"):
        monkeypatch.setenv(name, "1" if on else "0")


def _delta(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("flags,dtype", [(False, "float32"), (True, "float32"),
                                         (True, "bfloat16")])
def test_replayed_distill_steps_equal_eager_steps(cuda, monkeypatch, flags, dtype):
    _flags(monkeypatch, flags)
    cfg = _cfg(dtype)
    teacher = DiffusionModel.from_config(cfg.training_args, device="cpu", seed=6).state_dict()
    data = DeviceDataset.from_cache(
        synthetic_cache(n=16, max_seq_len=T_LEN, max_text_len=L_LEN, seed=1), cuda)
    eager, graphed = (Distiller(cfg, teacher, lr=1e-3, device=cuda) for _ in range(2))
    gen = torch.Generator(cuda).manual_seed(7)
    draws = [eager.draw(gen, data.size, T_LEN) for _ in range(6)]
    before = launch_counts()
    rows_e = torch.stack([eager.step(data.arrays, d) for d in draws])
    n_e = _delta(before)
    step = graphed.make_step_fn(data)
    before = launch_counts()
    rows_g = torch.stack([step(d) for d in draws])
    n_g = _delta(before)
    assert graphed.graph is not None and graphed.graph.graph is not None
    assert rows_g.shape == (6, 3) and torch.isfinite(rows_g).all()
    assert torch.equal(rows_g, rows_e)
    for a, b in ((eager.opt.params, graphed.opt.params), (eager.opt.mu, graphed.opt.mu),
                 (eager.opt.nu, graphed.opt.nu)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert n_g == n_e
    assert n_e == ({"fused_attention": 27 * 6, "fused_conv_block": 18 * 6} if flags else {})


def _eval_inputs(cache, sl, seed, dev):
    s3 = torch.as_tensor(cache.strokes[sl], dtype=torch.float32).to(dev)
    text = torch.as_tensor(np.asarray(cache.text[sl], np.int64)).to(dev)
    style = torch.as_tensor(cache.style[sl], dtype=torch.float32).to(dev)
    gen = torch.Generator(dev).manual_seed(seed * 1_000_003 + sl.start)
    return s3, text, style, torch.randn(s3[..., :2].shape, generator=gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [False, True])
def test_replayed_eval_equals_eager_eval_batch(cuda, monkeypatch, flags):
    _flags(monkeypatch, flags)
    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 2},
                                       dtype=torch.bfloat16, device=cuda, seed=2)
    cache = synthetic_cache(n=20, max_seq_len=T_LEN, max_text_len=L_LEN, seed=4)
    step, rows = make_eval_fn(model), []
    assert isinstance(step, EvalGraphs)

    def recorded(*args):
        rows.append(step(*args))
        return rows[-1]

    before = launch_counts()
    got = evaluate(model, cache, batch_size=8, seed=1, eval_step=recorded)
    n_g = _delta(before)
    assert step.captures == 2 and len(step.graphs) == 2  # 8 rows, then the tail of 4
    levels, want, before = eval_levels(), [], launch_counts()
    for i in range(0, 20, 8):
        want.append(eval_batch(model, *_eval_inputs(cache, slice(i, min(i + 8, 20)), 1, cuda),
                               levels))
    n_e = _delta(before)
    assert len(rows) == 3 and all(torch.equal(a, b) for a, b in zip(rows, want))
    assert np.array_equal(got, np.average(np.stack([w.cpu().numpy() for w in want]), axis=0,
                                          weights=[8, 8, 4]))
    assert n_g == n_e == ({"fused_attention": 9 * 18, "fused_conv_block": 6 * 18} if flags
                          else {})


@pytest.mark.cuda
def test_eval_graph_reads_an_in_place_update_and_recaptures_a_new_storage(cuda):
    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 2},
                                       dtype=torch.bfloat16, device=cuda, seed=2)
    cache = synthetic_cache(n=8, max_seq_len=T_LEN, max_text_len=L_LEN, seed=4)
    batch = _eval_inputs(cache, slice(0, 8), 0, cuda)
    step, levels = make_eval_fn(model), eval_levels()
    first = step(*batch)
    assert torch.equal(step(*batch), first) and step.captures == 1
    with torch.no_grad():
        model.output_dense.weight.mul_(1.5)  # in place: same storage, no capture
    moved = step(*batch)
    assert step.captures == 1 and not torch.equal(moved, first)
    assert torch.equal(moved, eval_batch(model, *batch, levels))
    with torch.no_grad():
        model.output_dense.weight.data = model.output_dense.weight.data * 0.5  # new storage
    again = step(*batch)
    assert step.captures == 2
    assert torch.equal(again, eval_batch(model, *batch, levels))
