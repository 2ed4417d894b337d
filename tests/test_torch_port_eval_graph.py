"""make_eval_fn and evaluate(eval_step=) (dhg_torch/eval.py), on the CPU:
the graph keys (the tail batch its own key, each kernel mode, dtype and
training flag in the key), the CPU step eager and equal to eval_batch, and
evaluate with a prebuilt step equal to evaluate without one and to the
eager loop it had before, over a cache with a tail. The replay runs on the
card (test_torch_port_distill_eval_graph_cuda.py); dhg parity stays with
test_torch_port_train.py::test_eval_batch_matches_dhg, since the graph
captures that same eval_batch.
"""

import numpy as np
import pytest
import torch

from dhg_torch.core import graphs as graphs_mod
from dhg_torch.data.pipeline import synthetic_cache
from dhg_torch.eval import EvalGraphs, eval_batch, eval_levels, evaluate, make_eval_fn
from dhg_torch.models.denoiser import DiffusionModel

torch.set_num_threads(1)

T_LEN, L_LEN = 16, 14
FLAGS = ("DHG_FUSED_BOTTLENECK", "DHG_FUSED_T4", "DHG_FUSED_ATTENTION", "DHG_FUSED_CONVBLOCK")


def _model(dtype=None):
    return DiffusionModel.from_config({"channels": 16, "att_layers_num": 1}, dtype=dtype,
                                      device="cpu", seed=4)


def _batch(rows, seed=0):
    c = synthetic_cache(n=rows, max_seq_len=T_LEN, max_text_len=L_LEN, seed=seed)
    return (torch.as_tensor(c.strokes), torch.as_tensor(np.asarray(c.text, np.int64)),
            torch.as_tensor(c.style))


def test_keys_split_the_tail_dtype_training_and_each_kernel_mode(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    model, full, tail = _model(), _batch(4), _batch(2)
    key = EvalGraphs.key(model, *full)
    assert key == EvalGraphs.key(model, *_batch(4, seed=9))  # values are not in the key
    assert key.rows == 4 and key.seq_len == T_LEN and key.text_len == L_LEN
    assert key.style == (14, 1280) and key.n_levels == 6
    assert EvalGraphs.key(model, *tail) != key and EvalGraphs.key(model, *tail).rows == 2
    assert EvalGraphs.key(model, *full, n_levels=3) != key
    assert EvalGraphs.key(_model(torch.bfloat16), *full) != key
    assert EvalGraphs.key(model.train(), *full) != key
    model.eval()
    keys = {key}
    for name, value in (("DHG_FUSED_BOTTLENECK", "0"), ("DHG_FUSED_T4", "1"),
                        ("DHG_FUSED_ATTENTION", "1"), ("DHG_FUSED_CONVBLOCK", "1")):
        monkeypatch.setenv(name, value)
        keys.add(EvalGraphs.key(model, *full))
    assert len(keys) == 5  # every flag moved the key


def test_cpu_step_is_eager_eval_batch(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a graph was built on the CPU")

    monkeypatch.setattr(graphs_mod, "CapturedBody", refused)
    model = _model()
    strokes3, text, style = _batch(3)
    eps = torch.randn(strokes3[..., :2].shape, generator=torch.Generator().manual_seed(1))
    step = make_eval_fn(model, n_levels=4)
    assert not isinstance(step, EvalGraphs)
    got = step(strokes3, text, style, eps)
    assert got.shape == (3,) and torch.isfinite(got).all()
    assert torch.equal(got, eval_batch(model, strokes3, text, style, eps, eval_levels(4)))


@pytest.mark.parametrize("n_levels", [6, 3])
def test_evaluate_with_a_prebuilt_step_equals_evaluate(n_levels):
    model = _model().train()  # evaluate puts it in eval mode and back
    cache = synthetic_cache(n=10, max_seq_len=T_LEN, max_text_len=L_LEN, seed=7)
    calls = []
    step = make_eval_fn(model, n_levels=n_levels)

    def recorded(*args):
        calls.append(args[0].shape[0])
        return step(*args)

    got = evaluate(model, cache, batch_size=4, seed=3, n_levels=n_levels, eval_step=recorded)
    assert calls == [4, 4, 2] and model.training  # the tail at its natural size
    assert np.array_equal(got, evaluate(model, cache, batch_size=4, seed=3, n_levels=n_levels))
    # The loop evaluate ran before it took a step: eval_batch per batch.
    model.eval()
    rows, weights, levels = [], [], eval_levels(n_levels)
    for i in range(0, 10, 4):
        sl = slice(i, min(i + 4, 10))
        s3 = torch.as_tensor(cache.strokes[sl], dtype=torch.float32)
        gen = torch.Generator().manual_seed(3 * 1_000_003 + i)
        eps = torch.randn(s3[..., :2].shape, generator=gen)
        rows.append(eval_batch(model, s3, torch.as_tensor(np.asarray(cache.text[sl], np.int64)),
                               torch.as_tensor(cache.style[sl]), eps, levels).numpy())
        weights.append(sl.stop - sl.start)
    assert np.array_equal(got, np.average(np.stack(rows), axis=0, weights=weights))
