"""training_args.steps_per_call in the port's train loop, on the CPU.

dhg scans up to 16 steps in one device program (dhg/train.py:535-567);
the port runs the same chunk loop (dhg_torch/train.py), with each chunk's
steps eager on the CPU and replayed from one captured CUDA graph on a card
(tests/test_torch_port_train_graph_cuda.py and chip_smoke.py hold the
replay to the eager steps there). Here:

* the log and checkpoint steps with auto, 4 and 1 are dhg's reference
  cadence (tests/test_chunked_train.py::_reference_cadence);
* the chunk sizes are those of dhg's own Trainer.train, driven with its
  step, chunk, init and data functions replaced by recorders (no model,
  no compile), from step 0 and from a resumed middle step, with and
  without a validation set;
* a chunked run equals the per-step run bit for bit: params, EMA, Adam
  moments and every metrics.jsonl row but its time (dhg's own bar for the
  same check is rtol 1e-4: its scan is another XLA program; here the
  chunk runs the same eager ops);
* the rule that resolves k_max, and the helpers a replay relies on.

Tiny sizes (channels 16, 1 layer, batch 4, T 16), one thread.
"""

import json
import logging
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dhg.eval
from dhg.config import DLConfig as JaxConfig
from dhg.train import Trainer as JaxTrainer
from dhg_torch import config as cf
from dhg_torch import train as tr
from dhg_torch.kernels import fused_attention as fa
from dhg_torch.kernels.runtime import add_launches, launch_counts
from dhg_torch.ops.basic import clear_cast_caches
from test_chunked_train import _reference_cadence

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

STEPS, LOG_FREQ, SAVE_FREQ = 12, 5, 5
TINY = ["--config=smoke.yml", "--training_args.channels=16", "--training_args.att_layers_num=1",
        "--training_args.batch_size=4", "--training_args.max_files=8",
        "--dataset_args.max_seq_len=16", "--dataset_args.max_text_len=14",
        "--training_args.compute_dtype=float32", "--training_args.ema_decay=0.9",
        f"--training_args.steps={STEPS}", f"--training_args.log_freq={LOG_FREQ}",
        f"--training_args.save_freq={SAVE_FREQ}"]
LINE = re.compile(r"Step (\d+) \| Loss: [\d.]+ \| Score: [\d.]+ \| Pen: [\d.]+ \| Time: [\d.]+ sec")


def _train(tmp_path, name, *extra, chunks=None):
    """tr.main on the tiny config; `chunks`, a list, records the size of
    every chunk of more than one step."""
    cfg = cf.config_entrypoint([*TINY, *extra, f"--experiment.work_dir={tmp_path / name}"])
    if chunks is None:
        return tr.main(cfg, device="cpu")
    chunk = tr.Trainer.train_chunk

    def recorded(self, first, k):
        chunks.append(k)
        return chunk(self, first, k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr.Trainer, "train_chunk", recorded)
        return tr.main(cfg, device="cpu")


def _saved_steps(run):
    return sorted(int(p.name.split("_")[1]) for p in run.glob("checkpoint_[0-9]*"))


@pytest.mark.parametrize("spc", ["auto", 4, 1])
def test_log_and_save_cadence_is_dhgs(tmp_path, spc):
    trainer = _train(tmp_path, "run", f"--training_args.steps_per_call={spc}",
                     "--training_args.keep_checkpoints=0")
    run = trainer.exp_dir
    assert [int(s) for s in LINE.findall((run / "run.log").read_text())] == \
        _reference_cadence(STEPS, LOG_FREQ)
    assert _saved_steps(run) == _reference_cadence(STEPS, SAVE_FREQ)
    assert (run / "model_final").exists()


class _Saver:
    def submit(self, *a, **k):
        raise AssertionError("write_artifacts is off")

    def wait(self):
        pass


def _dhg_chunks(monkeypatch, steps, save_freq, val_freq, start, spc):
    """The chunk sizes of dhg's Trainer.train: its state is the step count,
    its step and chunk functions record how many steps each call takes."""
    calls = []

    def state_at(count):
        return SimpleNamespace(count=count, params=None, opt_state=None, ema_params=None)

    def step_fn(state, key):
        calls.append(1)
        return state_at(state.count + 1), jnp.zeros(3)

    def chunk_fn(state, root_key, counts):
        counts = np.asarray(counts).tolist()
        assert counts == list(range(state.count + 1, state.count + len(counts) + 1))
        calls.append(len(counts))
        return state_at(state.count + len(counts)), jnp.zeros((len(counts), 3))

    t = JaxTrainer.__new__(JaxTrainer)
    t.cfg = JaxConfig({
        "experiment": {"seed": 0, "resume_from": "ck" if start else None},
        "training_args": {"steps": steps, "log_freq": 3, "save_freq": save_freq,
                          "val_freq": val_freq, "steps_per_call": spc}})
    t.write_artifacts, t.saver, t.batch_size, t.model = False, _Saver(), 4, None
    t.load_dataset = lambda: None
    t.init_state = lambda seed: state_at(0)
    t.resume_state = lambda state, path: (state_at(start), start)
    t.make_step_fn = lambda data: step_fn
    t.make_chunk_fn = lambda data: chunk_fn
    t.load_val_dataset = lambda: [0] * 4 if val_freq else None
    t.eval_fn = lambda: None
    monkeypatch.setattr(dhg.eval, "evaluate", lambda *a, **k: np.zeros(3))
    logger = logging.getLogger("dhg_chunks")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    assert t.train({"host_name": "h", "exp_dir": "."}, logger).count == steps
    return calls


@pytest.mark.parametrize("steps,save_freq,val_freq,start,spc", [
    (40, 10, None, 0, "auto"),
    (40, 10, 7, 0, "auto"),  # val_freq not a multiple of save_freq
    (37, 10, 7, 13, "auto"),  # resumed from a middle step
    (37, 10, 7, 13, 4),
    (50, 12, 5, 7, 8),
    (20, 5, None, 3, 1),
    (70, 50, None, 0, None),  # unset is auto
])
def test_chunk_sizes_are_dhgs(monkeypatch, steps, save_freq, val_freq, start, spc):
    want = _dhg_chunks(monkeypatch, steps, save_freq, val_freq, start, spc)
    assert tr.chunk_sizes(start, steps, tr.steps_per_call(spc, "cpu"), save_freq,
                          val_freq) == want


def _state(trainer):
    opt = trainer.opt
    return ([p.detach().clone() for p in opt.params], [e.clone() for e in trainer.ema],
            [m.clone() for m in opt.mu], [v.clone() for v in opt.nu], opt.count)


def _rows(run):
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    for r in rows:
        r.pop("time", None)
    return rows


def test_chunked_run_equals_per_step_run_bit_for_bit(tmp_path):
    """auto (chunks 4, 1, 4, 2, 1 at save and validation boundaries, dropout
    and cond dropout live) against steps_per_call 1, from one seed."""
    extra = ["--training_args.val_freq=6", "--training_args.dropout=0.1",
             "--training_args.cond_dropout=0.2", "--training_args.keep_checkpoints=0"]
    chunks = []
    a = _train(tmp_path, "auto", *extra, chunks=chunks)
    b = _train(tmp_path, "one", "--training_args.steps_per_call=1", *extra)
    assert tr.chunk_sizes(0, STEPS, 16, SAVE_FREQ, 6) == [4, 1, 4, 2, 1]
    assert chunks == [4, 4, 2]
    for x, y in zip(_state(a)[:4], _state(b)[:4]):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert _state(a)[4] == _state(b)[4] == STEPS
    rows = _rows(a.exp_dir)
    assert rows == _rows(b.exp_dir)
    assert [r["step"] for r in rows if "val_loss" in r] == [6, 12]
    assert _saved_steps(a.exp_dir) == _saved_steps(b.exp_dir) == [5, 10]


def test_resumed_chunked_run_equals_resumed_per_step_run(tmp_path):
    """From checkpoint_5 (dhg's label: saved after count 4, resumed at count
    5, as dhg resumes) auto runs dhg's chunks from the middle step and ends
    where the per-step loop ends, bit for bit: the draws are a function of
    (seed, count)."""
    first = _train(tmp_path, "first", "--training_args.steps_per_call=1")
    resume = f"--experiment.resume_from={first.exp_dir / 'checkpoint_5'}"
    chunks = []
    a = _train(tmp_path, "auto", resume, chunks=chunks)
    b = _train(tmp_path, "one", resume, "--training_args.steps_per_call=1")
    assert chunks == [k for k in tr.chunk_sizes(5, STEPS, 16, SAVE_FREQ) if k > 1] == [4, 2]
    for x, y in zip(_state(a)[:4], _state(b)[:4]):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert _rows(a.exp_dir) == _rows(b.exp_dir) != []


@pytest.mark.parametrize("value,device,backend,profile,want", [
    ("auto", "cpu", None, None, 16), (None, "cuda", None, None, 16), (4, "cuda", "nccl", None, 4),
    ("8", "cpu", None, None, 8), (0, "cpu", None, None, 1), (-3, "cuda", None, None, 1),
    ("auto", "cuda", None, "/tmp/trace", 1), (8, "cuda", "gloo", "/tmp/trace", 1),
    ("auto", "cpu", "gloo", None, 16), (4, "cpu", "gloo", None, 4),
    ("auto", "cuda", "gloo", None, 1), (1, "cuda", "gloo", None, 1),
])
def test_steps_per_call_rule(value, device, backend, profile, want):
    assert tr.steps_per_call(value, device, backend, profile) == want


def test_steps_per_call_under_gloo_on_cuda_logs_or_raises():
    seen = []

    class Log:
        def info(self, msg):
            seen.append(msg)

    assert tr.steps_per_call("auto", "cuda", "gloo", logger=Log()) == 1
    assert seen == ["steps_per_call auto is 1 under the gloo process group "
                    "(a CUDA graph cannot capture its collectives)"]
    with pytest.raises(ValueError, match="steps_per_call=4: on CUDA under a gloo process group"):
        tr.steps_per_call(4, "cuda", "gloo")


def test_optimizer_stages_the_step_scalars_in_float32():
    """stage() writes -lr(count), 1 - b1^n and 1 - b2^n (n = count + 1) in
    float32 into the device buffer update() reads, and counts the step."""
    model = torch.nn.Linear(3, 2)
    opt = tr.Optimizer(model, "adam", tr.noam_schedule(16, 10), betas=(0.9, 0.98))
    for n in (1, 2, 3):
        opt.stage()
        f32 = np.float32
        want = [-tr.noam_schedule(16, 10)(n - 1), 1 - f32(0.9) ** f32(n), 1 - f32(0.98) ** f32(n)]
        assert opt.scalars.dtype == torch.float32 and opt.count == n
        assert opt.scalars.tolist() == [float(f32(v)) for v in want]


def test_cast_caches_clear_and_launch_counts_add():
    from dhg_torch.models.denoiser import DiffusionModel

    model = DiffusionModel.from_config({"channels": 16, "att_layers_num": 1},
                                       dtype=torch.bfloat16, device="cpu", seed=0)
    with torch.no_grad():
        model.input_dense.cast(torch.bfloat16)
    assert model.input_dense._cast_cache
    clear_cast_caches(model)
    assert all(getattr(m, "_cast_cache", None) is None for m in model.modules())

    before = launch_counts()
    assert {"fused_attention", "fused_conv_block", "fused_bottleneck", "fused_encoder_layer",
            "fused_unet_t4"} <= set(before)
    add_launches({"fused_attention": 9, "fused_conv_block": 6})
    after = launch_counts()
    assert after["fused_attention"] == before["fused_attention"] + 9
    assert after["fused_conv_block"] == before["fused_conv_block"] + 6
    add_launches({"fused_attention": -9, "fused_conv_block": -6})
    assert launch_counts() == before and fa.launches["fused_attention"] == before[
        "fused_attention"]


def test_embedding_gradient_is_one_product():
    """ops.basic.Embedding: F.embedding's forward bit for bit; the weight's
    gradient one_hot(ids)^T @ grad, within f32 rounding of nn.Embedding's
    (the same sums in another order), with repeated and absent ids."""
    from dhg_torch.ops.basic import Embedding

    torch.manual_seed(0)
    ours, ref = Embedding(11, 6), torch.nn.Embedding(11, 6)
    ref.weight.data.copy_(ours.weight.data)
    ids = torch.tensor([[3, 3, 0, 7, 10], [7, 3, 1, 1, 2]], dtype=torch.int32)
    g = torch.randn(2, 5, 6)
    out = ours(ids)
    assert torch.equal(out, ref(ids))
    out.backward(g)
    ref(ids).backward(g)
    torch.testing.assert_close(ours.weight.grad, ref.weight.grad, rtol=1e-6, atol=1e-6)
    assert not ours.weight.grad[[4, 5, 6, 8, 9]].any()
    with torch.no_grad():
        assert torch.equal(ours(ids), out)
