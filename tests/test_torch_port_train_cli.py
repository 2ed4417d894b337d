"""The port's training CLI on the CPU and what it writes: run.log in the
reference's line format, metrics.jsonl, checkpoint_<N> with retention,
model_final (loaded by DiffusionModel.load, which then samples), resume,
the interrupt save; and the config and checkpoint helpers it rests on."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch import checkpoint as ck
from dhg_torch import config as cf
from dhg_torch import train as tr
from dhg_torch.inference import generate
from dhg_torch.models.denoiser import DiffusionModel

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--config=smoke.yml", "--training_args.channels=16", "--training_args.att_layers_num=1",
        "--training_args.batch_size=4", "--training_args.max_files=8",
        "--dataset_args.max_seq_len=32", "--dataset_args.max_text_len=14",
        "--training_args.log_freq=2", "--training_args.save_freq=2",
        "--training_args.compute_dtype=float32", "--training_args.ema_decay=0.9",
        "--training_args.keep_checkpoints=1"]
LINE = re.compile(r"Step (\d+) \| Loss: [\d.]+ \| Score: [\d.]+ \| Pen: [\d.]+ \| Time: [\d.]+ sec")


def _run_dir(work_dir: Path) -> Path:
    (run,) = work_dir.glob("*/*/*")
    return run


def _metrics(run: Path) -> list[dict]:
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_cli_trains_saves_resumes_and_samples(tmp_path):
    res = subprocess.run([sys.executable, "-m", "dhg_torch.train", "--device=cpu", *TINY,
                          "--training_args.steps=4", f"--experiment.work_dir={tmp_path / 'a'}"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    run = _run_dir(tmp_path / "a")
    names = {p.name for p in run.iterdir()}
    assert {"run.log", "metrics.jsonl", "checkpoint_4", "model_final", "config.yml",
            "report.json"} <= names
    assert "checkpoint_2" not in names  # keep_checkpoints=1 pruned it
    log = (run / "run.log").read_text()
    assert [int(m) for m in LINE.findall(log)] == [2, 4]
    assert [m["step"] for m in _metrics(run)] == [2, 4]
    saved = ck.load_checkpoint(run / "checkpoint_4")
    assert saved["step"] == 4 and {"state_dict", "optimizer", "ema_state_dict"} <= set(saved)
    assert cf.DLConfig.load(run / "config.yml").training_args.steps == 4

    # Resume from checkpoint_4 to step 6, in process.
    cfg = cf.config_entrypoint([*TINY, "--training_args.steps=6",
                                f"--experiment.resume_from={run / 'checkpoint_4'}",
                                f"--experiment.work_dir={tmp_path / 'b'}"])
    trainer = tr.main(cfg, device="cpu")
    log2 = (trainer.exp_dir / "run.log").read_text()
    assert f"Resumed from {run / 'checkpoint_4'} at step 4" in log2
    assert [m["step"] for m in _metrics(trainer.exp_dir)] == [6]
    assert ck.load_checkpoint(trainer.exp_dir / "checkpoint_6")["step"] == 6
    assert ck.resolve_checkpoint(trainer.exp_dir) == trainer.exp_dir / "model_final"

    # model_final samples through the port's own loader (EMA weights first).
    ema = DiffusionModel.load(run / "model_final", device="cpu")
    raw = DiffusionModel.load(run / "model_final", use_ema=False, device="cpu")
    assert not torch.equal(ema.input_dense.weight, raw.input_dense.weight)
    out = generate(ema, np.array([[5, 6, 1, 0]]), np.zeros((1, 14, 1280), np.float32),
                   torch.Generator().manual_seed(0), seq_len=16, n_steps=2, device="cpu")
    assert out.shape == (1, 16, 3) and torch.isfinite(out).all()


def test_interrupt_saves_checkpoint_last(tmp_path, monkeypatch):
    cfg = cf.config_entrypoint([*TINY, "--training_args.steps=6", "--training_args.ema_decay=0",
                                f"--experiment.work_dir={tmp_path}"])
    step = tr.Trainer.train_step

    def interrupted(self, draws):
        tr._InterruptFlag.pending = self.opt.count == 2
        return step(self, draws)

    monkeypatch.setattr(tr.Trainer, "train_step", interrupted)
    trainer = tr.main(cfg, device="cpu")
    names = {p.name for p in trainer.exp_dir.iterdir()}
    assert {"checkpoint_last", "model_last"} <= names and "model_final" not in names
    assert ck.load_checkpoint(trainer.exp_dir / "checkpoint_last")["step"] == 3
    assert "Training interrupted by user." in (trainer.exp_dir / "run.log").read_text()
    assert not tr._InterruptFlag.pending


def test_unported_options_refuse(tmp_path):
    base = {"experiment": {}, "dataset_args": {}, "optimizer": {"type": "torch.optim.Adam"},
            "training_args": {"channels": 16, "att_layers_num": 1, "batch_size": 2,
                              "warmup_steps": 10}}
    mesh = json.loads(json.dumps(base))
    mesh["training_args"]["mesh"] = {"model_parallel": 2}
    # model_parallel is ported; it needs a process group of as many ranks.
    with pytest.raises(ValueError, match="model_parallel=2 needs as many processes"):
        tr.Trainer(cf.DLConfig(mesh), device="cpu")
    # dataset "iam" (the default) is ported: an empty train split raises, an
    # empty validation split reads as None, as in dhg.
    (tmp_path / "splits.json").write_text(json.dumps({"train": [], "validation": []}))
    base["experiment"] = {"data_dir": str(tmp_path), "splits_file": str(tmp_path / "splits.json")}
    base["training_args"]["cache_dir"] = str(tmp_path / "cache")
    with pytest.raises(RuntimeError, match="no valid IAM samples"):
        tr.load_cache(cf.DLConfig(base), "train", device="cpu")
    assert tr.load_cache(cf.DLConfig(base), "validation", device="cpu") is None


def test_config_reads_without_yaml(monkeypatch):
    cfg = cf.DLConfig({"a": {"b": 1, "c": {"d": [1, 2]}}})
    assert cfg.a.b == 1 and cfg.a.c.d == [1, 2] and cfg.a.missing is None and cfg.nothing is None
    monkeypatch.setattr(cf, "_yaml", lambda: None)
    assert json.loads(cfg.pretty_text) == {"a": {"b": 1, "c": {"d": [1, 2]}}}
    assert cf.parse_cli_kwargs(["--x=3", "--y", "[1, 2]", "--flag", "--s=abc"]) == {
        "x": 3, "y": [1, 2], "flag": True, "s": "abc"}
    assert cf.merge_configs({"a": {"b": 1, "c": 2}}, {"a": {"c": 3}}) == {"a": {"b": 1, "c": 3}}
    assert cf.object_from_dict({"type": "torch.optim.AdamW", "params": {"lr": 1}}) == (
        "adamw", {"lr": 1})
    with pytest.raises(ImportError):
        cf.object_from_dict({"type": "os.system"})
    with pytest.raises(SystemExit):
        cf.parse_cli_kwargs(["positional"])


def test_checkpoint_discovery_and_retention(tmp_path):
    sd = {"w": torch.ones(2)}
    assert ck.resolve_checkpoint(tmp_path) is None
    for n in (3, 12, 7):
        ck.save_checkpoint(tmp_path / f"checkpoint_{n}", sd, step=n)
    (tmp_path / "checkpoint_notes").write_text("not a checkpoint")
    assert ck.resolve_checkpoint(tmp_path) == tmp_path / "checkpoint_12"
    ck.save_checkpoint(tmp_path / "model_last", sd)
    assert ck.resolve_checkpoint(tmp_path) == tmp_path / "model_last"
    ck.save_checkpoint(tmp_path / "model_final", sd)
    assert ck.resolve_checkpoint(tmp_path) == tmp_path / "model_final"
    assert ck.prune_numbered_checkpoints(tmp_path, 2) == [tmp_path / "checkpoint_3"]
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["checkpoint_12", "checkpoint_7", "checkpoint_notes", "model_final", "model_last"]
    saver = ck.AsyncSaver()
    t = torch.zeros(2)
    saver.submit(tmp_path / "snap", {"w": t}, step=1)
    t += 5  # the saver wrote the snapshot taken at submit
    saver.wait()
    assert torch.equal(ck.load_checkpoint(tmp_path / "snap")["state_dict"]["w"], torch.zeros(2))
