"""The port's contract: entry points run on the card unless the caller asks
for the CPU, and nothing in dhg_torch/ or chip_smoke.py imports JAX, flax or
the dhg package."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch import resolve_device
from dhg_torch.inference import generate, sample_lines
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.config import DLConfig
from dhg_torch.train import Trainer, main

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dhg_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "dhg"}


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
    cfg = DLConfig({"experiment": {"work_dir": str(tmp_path / "runs")}, "dataset_args": {},
                    "optimizer": {"type": "torch.optim.Adam"},
                    "training_args": {"channels": 16, "att_layers_num": 1, "batch_size": 2,
                                      "warmup_steps": 10, "dataset": "synthetic"}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(cfg)
    assert not (tmp_path / "runs").exists()  # refused before it made a run dir


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
