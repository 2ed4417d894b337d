"""The port's seven sampler and training tools (dhg_torch/tools) run as CLIs
at a tiny size on the CPU (--device=cpu): each report carries the keys of
dhg's tool, read from dhg's source, plus `backend`; plot_run's parsers
return dhg's dicts on the same text and the CLI writes a PNG.

Tiny size: the tools that build the canonical model (sweep, bench_hoist,
profile_stages) run it at seq_len 24 and 2 steps (the last two through
their module constants); the others sample a 16-channel checkpoint.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.tools import (bench_hoist, eval_encoder_reuse, eval_fewer_steps,
                             eval_parallel_sampler, plot_run, profile_stages, sweep)

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

ROOT = Path(__file__).resolve().parents[1]


def dhg_keys(tool: str, function: str) -> set[str]:
    """Every string key of a dict literal, or of a subscript assignment, in
    `function` of dhg/tools/<tool>.py, but flax's {"params": ...}."""
    tree = ast.parse((ROOT / "dhg" / "tools" / f"{tool}.py").read_text())
    (fn,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function]
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys - {"params"}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run dir holding a 16-channel, 1-layer model_final (float32)."""
    run = tmp_path_factory.mktemp("run")
    model = DiffusionModel.from_config({"channels": 16, "att_layers_num": 1}, device="cpu",
                                       seed=3)
    torch.save({"meta": {}, "state_dict": model.state_dict()}, run / "model_final")
    return run


def test_eval_fewer_steps_cli(run_dir):
    report = eval_fewer_steps.main(["--device=cpu", f"--experiment_path={run_dir}", "--batch=2",
                                    "--prompt_len=2", "--steps=60,3", "--diffusion_mode=ddim"])
    (row60, row3) = report["rows"]
    assert set(report) | set(row60) == dhg_keys("eval_fewer_steps", "evaluate_fewer_steps") | {
        "backend"}
    assert report["backend"] == "cpu" and report["seq_len"] == 40
    assert row60["stroke_mse"] == 0.0  # 60 strided levels are the canonical table
    assert np.isfinite(row3["stroke_mse"]) and row3["stroke_mse"] > 0
    assert all(r["ms_per_call"] > 0 and 0.0 <= r["pen_flip_rate"] <= 1.0 for r in report["rows"])


def test_eval_encoder_reuse_cli(run_dir):
    report = eval_encoder_reuse.main(["--device=cpu", f"--experiment_path={run_dir}",
                                      "--batch=2", "--prompt_len=2", "--reuse=1,2"])
    (row1, row2) = report["rows"]
    assert set(report) | set(row1) == dhg_keys("eval_encoder_reuse", "evaluate_reuse") | {
        "backend"}
    assert row1["stroke_mse"] == 0.0 and row1["under_1e-3_bar"]  # k = 1 is the exact sampler
    assert np.isfinite(row2["stroke_mse"]) and row2["stroke_mse"] > 0


def test_eval_parallel_sampler_cli(run_dir, capsys):
    report = eval_parallel_sampler.main(["--device=cpu", f"--experiment_path={run_dir}",
                                         "--tokens=1", "--sweeps=1,3", "--iters=1"])
    out = capsys.readouterr().out
    assert "backend cpu" in out and "sequential ddim  batch=1 T=24:" in out
    assert "sweeps   ms/call  vs seq  stroke MSE" in out
    assert [r["sweeps"] for r in report["rows"]] == [1, 3]
    assert all(np.isfinite(r["stroke_mse"]) and r["ms_per_call"] > 0 for r in report["rows"])
    assert report["sampler_kernel_launches"] == {"fused_bottleneck": 0, "fused_encoder_layer": 0,
                                                 "fused_unet_t4": 0}


def test_sweep_cli(capsys):
    rows = sweep.main(["--device=cpu", "--batches=1", "--steps=2", "--guidance=1.0,2.0",
                       "--prompt_len=1"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and [r["guidance"] for r in rows] == [1.0, 2.0]
    for r in rows:
        assert set(r) == dhg_keys("sweep", "main") | {"backend"}
        assert r["seq_len"] == 24 and r["time_s"] > 0 and r["backend"] == "cpu"


def test_bench_hoist_cli(monkeypatch, capsys):
    monkeypatch.setattr(bench_hoist, "N_STEPS", 2)
    monkeypatch.setattr(bench_hoist, "SEQ_LEN", 24)
    grid = bench_hoist.main(["--device=cpu", "--batches=1"])
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in lines[:2]] == grid
    assert lines[2].startswith("BEST: ") and json.loads(lines[2][6:]) in grid
    assert [g["hoist"] for g in grid] == ["full", "compact"]
    assert set(grid[0]) == dhg_keys("bench_hoist", "measure") - {"error", "detail"} | {"backend"}


def test_profile_stages_cli(monkeypatch):
    monkeypatch.setattr(profile_stages, "N_STEPS", 2)
    monkeypatch.setattr(profile_stages, "ITERS", 1)
    report = profile_stages.main(["--device=cpu", "--batch=2", "--prompt_len=1"])
    stages = {"full", "enc1", "enc2_enc3", "enc4_enc5", "att_stack", "decoder"}
    assert set(report) == dhg_keys("profile_stages", "profile") - stages | {"kernels"}
    assert set(report["ms_per_step"]) == set(report["kernels"]) == stages
    assert set(report["pct_of_full"]) == stages - {"full"}
    assert all(v > 0 for v in report["ms_per_step"].values())
    assert all(k == {} for k in report["kernels"].values())  # no kernel on the CPU


LOG = """\
2026-01-01 - [INFO] Step 2 | Loss: 3.125 | Score: 2.5 | Pen: 0.625 | Time: 1.0 sec
2026-01-01 - [INFO] Step 2 | Val Loss: 3.5 | Val Score: 2.75 | Val Pen: 0.75
noise line
2026-01-01 - [INFO] Step 4 | Loss: 1.5e-1 | Score: 1e-1 | Pen: 5.0E-2 | Time: 2.0 sec
"""
JSONL = ('{"step": 2, "loss": 3.1, "score": 2.5, "pen": 0.6, "time": 1.0}\n\n'
         '{"step": 2, "val_loss": 3.5, "val_score": 2.75, "val_pen": 0.75}\n'
         '{"step": 4, "loss": 0.15, "score": 0.1, "pen": 0.05, "time": 2.0}\n')


def test_plot_run_parsers_match_dhg_and_the_cli_writes_a_png(tmp_path, capsys):
    from dhg.tools import plot_run as dhg_plot_run
    from dhg_torch.data.images import read_png

    assert plot_run.parse_log(LOG) == dhg_plot_run.parse_log(LOG)
    assert plot_run.parse_jsonl(JSONL) == dhg_plot_run.parse_jsonl(JSONL)
    (tmp_path / "run.log").write_text(LOG)
    assert plot_run.load_history(tmp_path) == dhg_plot_run.load_history(tmp_path)
    (tmp_path / "metrics.jsonl").write_text(JSONL)
    assert plot_run.load_history(tmp_path) == dhg_plot_run.load_history(tmp_path)
    assert plot_run.load_history(log=tmp_path / "run.log") == dhg_plot_run.parse_log(LOG)

    out = plot_run.main(["--experiment_path", str(tmp_path)])
    assert out == tmp_path / "loss_curves.png"
    assert capsys.readouterr().out.strip() == f"wrote {out} (2 train rows, 1 val rows)"
    img = read_png(out)
    assert img.shape == (600, 1080, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    assert set(plot_run.COLOURS) <= colours  # every curve drew
    with pytest.raises(ValueError, match="no loss rows"):
        plot_run.plot_history({"train": [], "val": []}, tmp_path / "empty.png")
