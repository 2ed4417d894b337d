"""The port's distillation probe and CLIs on the CPU.

probe_samples (what distill.py::probe_fidelity logs) against dhg's: the
teacher's 60-step and a student's 30-step DDIM on the probe prompt with
zero style, from one x_T, each within the sampler bar (1e-3 stroke MSE) of
dhg's `generate` on the same weights. The x_T is the one dhg draws from
PRNGKey(1234) (split(key)[0]). The student is a second transplanted init:
the probe samples whatever weights it is given. C1 = 16, one attention
layer, f32.

Then the CLIs end to end: a 2-step teacher run (dhg_torch.train), a
2-step distillation (dhg_torch.distill), the student's config and its
`infer` defaults, and tools/probe_distill's JSON keys against dhg's.
"""

import ast
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dhg.data.tokenizer import Tokenizer as JaxTokenizer
from dhg.inference import generate as jax_generate
from dhg.inference import infer_seq_len
from dhg_torch.config import DLConfig
from dhg_torch.distill import PROBE_PROMPT, PROBE_SEED, probe_samples
from test_torch_port_common import jax_model, port_model, random_params
from test_torch_port_distill import CFG

ROOT = Path(__file__).resolve().parents[1]
C1, LAYERS = 16, 1


def test_probe_samples_match_dhg():
    tparams = random_params(seed=8, c1=C1, num_layers=LAYERS)
    sparams = random_params(seed=9, c1=C1, num_layers=LAYERS)
    text = jnp.asarray([JaxTokenizer().encode(PROBE_PROMPT)], jnp.int32)
    seq_len = infer_seq_len(text.shape[1])
    key = jax.random.PRNGKey(PROBE_SEED)
    jm = jax_model(c1=C1, num_layers=LAYERS)
    kw = dict(seq_len=seq_len, diffusion_mode="ddim", schedule="halved")
    style = jnp.zeros((1, 14, 1280))
    ref_t = jax_generate(jm, tparams, text, style, key, n_steps=60, **kw)
    ref_s = jax_generate(jm, sparams, text, style, key, n_steps=30, **kw)
    x_init = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0],
                                                         (1, seq_len, 2))))
    out_t, out_s = probe_samples(port_model(tparams, c1=C1, num_layers=LAYERS),
                                 port_model(sparams, c1=C1, num_layers=LAYERS), 60, 30,
                                 x_init=x_init, device="cpu")
    for got, want in ((out_t, ref_t), (out_s, ref_s)):
        assert got.shape == want.shape == (1, seq_len, 3)
        assert torch.isfinite(got).all()
        assert float(np.mean((got.numpy() - np.asarray(want)) ** 2)) < 1e-3


def _dhg_probe_keys() -> set[str]:
    """The keys dhg's probe_distill puts in its JSON, read from its source."""
    tree = ast.parse((ROOT / "dhg" / "tools" / "probe_distill.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "out" \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "out" \
                and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def test_cli_end_to_end(tmp_path, monkeypatch):
    """A 2-step teacher run, a 2-step distillation, the student's config, its
    infer defaults and the probe CLI's JSON keys."""
    from dhg_torch import inference as tinf
    from dhg_torch.data.images import write_png
    from dhg_torch.distill import main as distill_main
    from dhg_torch.tools.probe_distill import main as probe_main
    from dhg_torch.train import main as train_main
    from test_torch_port_style import SYNTH, _line_image

    cfg = copy.deepcopy(CFG)
    cfg["training_args"].update(steps=2, log_freq=1, save_freq=2)
    cfg["experiment"]["work_dir"] = str(tmp_path / "runs")
    teacher = train_main(DLConfig(cfg), device="cpu").exp_dir
    student = distill_main([f"--experiment_path={teacher}", "--steps=2", "--device=cpu",
                            f"--experiment.work_dir={tmp_path / 'students'}"])
    assert student.parent.parent.name == "teacher_distill30"
    scfg = DLConfig.load(student / "config.yml")
    assert scfg.training_args.distilled_steps == 30
    assert scfg.training_args.compute_dtype == "float32"
    log = (student / "run.log").read_text()
    assert "Distill 60->30 | Step 2 | Loss: " in log and "Probe: student 30-step DDIM" in log

    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    real = tinf.generate
    monkeypatch.setattr(tinf, "generate", spy)
    write_png(tmp_path / "style.png", _line_image(np.random.RandomState(4)))
    strokes = tinf.infer(prompt="hi", source=str(tmp_path / "style.png"),
                         experiment_path=str(student), output=str(tmp_path / "out"),
                         style_weights=str(SYNTH), device="cpu")
    assert (seen["n_steps"], seen["schedule"], seen["diffusion_mode"]) == (30, "halved", "ddim")
    assert np.isfinite(strokes).all()
    monkeypatch.undo()

    out = probe_main([f"--teacher={teacher}", f"--student={student}", "--prompt=hi",
                      "--device=cpu"])
    single = {"teacher_steps", "student_steps", "n_prompts", "copy_vs_teacher_mse",
              "student_vs_teacher_mse", "distillation_wins"}
    assert set(out) == single and out["n_prompts"] == 1
    assert set(out) | {"copy_per_prompt", "student_per_prompt", "prompts_won"} == \
        _dhg_probe_keys()
    assert json.loads(json.dumps(out)) == out and np.isfinite(out["student_vs_teacher_mse"])
