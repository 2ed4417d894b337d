"""The train loop's chunks on the card (marker `cuda`; skipped without one):
each chunk's steps replayed from one captured CUDA graph of the step
(dhg_torch/train.py StepGraph) against the eager steps, bit for bit, at a
narrow width: params, EMA, Adam moments and every step's losses, with the
train kernels off and on and with dropout 0.1; the kernels' launch counts
equal the eager steps'; a validation after a chunk equals the eager one's
(the bf16 cast cache is dropped after a chunk); a CUDA graph left in a
dead reference cycle does not break the step's capture. No JAX here, so it runs
where the card is:
    python -m pytest --noconftest -m cuda tests/test_torch_port_train_graph_cuda.py -q
"""

import gc

import pytest
import torch

from dhg_torch.config import DLConfig
from dhg_torch.eval import evaluate
from dhg_torch.kernels.runtime import launch_counts
from dhg_torch.train import Trainer, load_cache


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(dropout):
    return DLConfig({
        "experiment": {"seed": 3},
        "dataset_args": {"max_seq_len": 64, "max_text_len": 14},
        "training_args": {"channels": 32, "att_layers_num": 1, "batch_size": 8, "max_files": 16,
                          "warmup_steps": 20, "clip_grad": 100.0, "clip_mode": "norm",
                          "ema_decay": 0.9, "dropout": dropout, "compute_dtype": "bfloat16",
                          "dataset": "synthetic"},
        "optimizer": {"type": "torch.optim.Adam",
                      "params": {"weight_decay": 1e-5, "betas": [0.9, 0.98]}},
    })


def _state(t):
    return [*(p.detach() for p in t.opt.params), *t.ema, *t.opt.mu, *t.opt.nu]


@pytest.mark.cuda
@pytest.mark.parametrize("flags,dropout", [("0", 0.0), ("1", 0.0), ("1", 0.1)])
def test_replayed_chunks_equal_eager_steps(cuda, monkeypatch, flags, dropout):
    monkeypatch.setenv("DHG_FUSED_ATTENTION", flags)
    monkeypatch.setenv("DHG_FUSED_CONVBLOCK", flags)
    cfg = _cfg(dropout)
    val = load_cache(cfg, "validation", cuda)
    runs = {}
    for mode in ("eager", "graph"):
        t = Trainer(cfg, device=cuda)
        before = launch_counts()
        evals = [evaluate(t.model, val, batch_size=8, seed=0)]
        if mode == "eager":
            rows = [t.train_step(t.draw(c))[None] for c in range(1, 7)]
            evals.append(evaluate(t.model, val, batch_size=8, seed=0))
            rows += [t.train_step(t.draw(c))[None] for c in range(7, 10)]
        else:
            rows = [t.train_chunk(1, 6)]
            evals.append(evaluate(t.model, val, batch_size=8, seed=0))
            rows.append(t.train_chunk(7, 3))
            assert t.graph is not None
        evals.append(evaluate(t.model, val, batch_size=8, seed=0))
        torch.cuda.synchronize()
        after = launch_counts()
        runs[mode] = (torch.cat(rows), _state(t), evals,
                      {k: v - before[k] for k, v in after.items()})
    (rows_e, st_e, ev_e, n_e), (rows_g, st_g, ev_g, n_g) = runs["eager"], runs["graph"]
    assert rows_g.shape == (9, 3) and torch.equal(rows_g, rows_e)
    assert all(torch.equal(a, b) for a, b in zip(st_g, st_e))
    assert all((a == b).all() for a, b in zip(ev_g, ev_e))
    assert n_g == n_e
    if flags == "1":
        assert n_e["fused_attention"] > 0 and n_e["fused_conv_block"] > 0


class _Cycle:
    def __init__(self, graph):
        self.graph, self.me = graph, self


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_and_a_collection(cuda):
    # A graph freed only by a garbage collection (a stopped server's, held by
    # its handler class) must not be destroyed inside the step's capture:
    # the capture collects first and holds the collector off.
    x = torch.ones(1024, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x * 2
    torch.cuda.current_stream().wait_stream(side)
    dead = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead):
        x * 2
    _Cycle(dead)
    del dead
    t = Trainer(_cfg(0.0), device=cuda)
    step, seen = t._step, []

    def collecting_step(d):
        seen.append(gc.isenabled())
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return step(d)

    t._step = collecting_step
    rows = t.train_chunk(1, 2)
    torch.cuda.synchronize()
    assert t.graph is not None and seen == [True, False]
    assert rows.shape == (2, 3) and torch.isfinite(rows).all()
