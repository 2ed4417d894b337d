"""The port's contract: entry points run on the card unless the caller asks
for the CPU, and nothing in dhg_torch/ or chip_smoke.py imports JAX, flax,
the dhg package or a library the card's machine lacks (cv2, PIL,
matplotlib, torchvision)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch import resolve_device
from dhg_torch.inference import generate, infer, sample_lines, style_from_image
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.config import DLConfig
from dhg_torch.distill import Distiller
from dhg_torch.distill import main as distill_main
from dhg_torch.tools import (bench_hoist, eval_encoder_reuse, eval_fewer_steps,
                             eval_fsd_sensitivity, eval_parallel_sampler, eval_style_gap,
                             eval_style_pathway, profile_stages, profile_train, sweep,
                             train_style_trunk)
from dhg_torch.tools.probe_distill import main as probe_main
from dhg_torch.train import Trainer, main

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dhg_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "dhg", "cv2", "PIL", "matplotlib",
          "torchvision"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_dhg_imports(path):
    assert path.is_file()
    assert not (_imported_roots(path) & BANNED), path


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_refuse_the_cpu_by_default(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionModel.from_config({"channels": 32})
    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 1}, device="cpu")
    torch.save({"meta": {}, "state_dict": model.state_dict()}, tmp_path / "m.pth")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionModel.load(tmp_path / "m.pth")
    text = np.array([[5, 6, 1, 0]])
    style = np.zeros((1, 14, 1280), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(model, text, style, seq_len=16, n_steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_lines(model, ["hi"], style, n_steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer(prompt="hi", source="style.png", config_path="config.yml",
              checkpoint_path=str(tmp_path / "m.pth"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        style_from_image("style.png")
    cfg = DLConfig({"experiment": {"work_dir": str(tmp_path / "runs")}, "dataset_args": {},
                    "optimizer": {"type": "torch.optim.Adam"},
                    "training_args": {"channels": 16, "att_layers_num": 1, "batch_size": 2,
                                      "warmup_steps": 10, "dataset": "synthetic"}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(cfg)
    assert not (tmp_path / "runs").exists()  # refused before it made a run dir
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Distiller(cfg, model.state_dict())
    (tmp_path / "run").mkdir()
    cfg.dump(tmp_path / "run" / "config.yml")
    torch.save({"meta": {}, "state_dict": model.state_dict()}, tmp_path / "run" / "model_final")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distill_main([f"--experiment_path={tmp_path / 'run'}", "--steps=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_main([f"--teacher={tmp_path / 'run'}", f"--student={tmp_path / 'run'}"])
    assert not (tmp_path / "runs").exists()
    # The sampler tools (plot_run has no device work and takes no --device).
    run = f"--experiment_path={tmp_path / 'run'}"
    for tool, argv in ((eval_fewer_steps, [run]), (eval_encoder_reuse, [run]),
                       (eval_parallel_sampler, [run]), (sweep, []), (bench_hoist, []),
                       (profile_stages, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(model, text, style, seq_len=16, n_steps=2, hoist="full", encoder_reuse=2)
    # dhg's train-step profile, as a function and as the CLI with dhg's flags.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_train.profile(steps_per_window=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_train.main(["--batch=4", "--steps_per_window=16"])


@pytest.mark.parametrize("tool,argv", [
    (train_style_trunk, ["--steps=60", "--writers=2", "--per_writer=1"]),
    (eval_style_gap, []),
    (eval_fsd_sensitivity, ["--cache=cache.npz"]),
    (eval_style_pathway, ["--experiment_path=run"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_style_tools_refuse_the_cpu_by_default(no_cuda, tool, argv, tmp_path):
    """The style-trunk tools, before any work or file, without --device."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv + [f"--out={tmp_path / 'trunk.npz'}"] if tool is train_style_trunk
                  else argv)
    assert not (tmp_path / "trunk.npz").exists()


def test_cpu_path_runs_when_asked():
    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 1}, device="cpu")
    assert DiffusionModel.load.__defaults__[-1] == "cuda"
    out = generate(model, np.array([[5, 6, 1, 0]]), np.zeros((1, 14, 1280), np.float32),
                   torch.Generator().manual_seed(0), seq_len=16, n_steps=2, device="cpu")
    assert out.shape == (1, 16, 3) and torch.isfinite(out).all()


def test_generate_rejects_a_model_on_another_device():
    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 1}, device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        generate(model, np.array([[5, 1]]), np.zeros((1, 14, 1280), np.float32),
                 seq_len=16, n_steps=2, device="meta")
