"""Cross-level distillation fidelity probe (port of
dhg/tools/probe_distill.py).

Compares, from the SAME x_T on the probe prompt (the probe
dhg_torch/distill.py::probe_fidelity logs each round):

  1. the teacher sampled on its full grid (--teacher_steps, default 60):
     the reference trajectory;
  2. the teacher sampled on the student's grid (--student_steps): the
     zero-training halved-grid baseline;
  3. the distilled student on the student's grid.

Distillation "wins" iff (3) < (2). Models load in float32, as dhg's
load_model loads them (the EMA weights where a checkpoint has them).

Usage:
    python -m dhg_torch.tools.probe_distill --teacher=<run dir> \
        --student=<distilled run dir> [--teacher_steps=60] \
        [--student_steps=<from the student's config>] [--prompt="..."] \
        [--multi=1]   # a fixed batch of 8 prompts instead of one line
        [--device=cpu]

Prints one JSON object: teacher_steps, student_steps, n_prompts,
copy_vs_teacher_mse, student_vs_teacher_mse, distillation_wins and, with
several prompts, copy_per_prompt, student_per_prompt, prompts_won.
"""

from __future__ import annotations

import json
import sys

import torch

from dhg_torch.distill import PROBE_PROMPT, PROBE_SEED

MULTI_PROMPTS = [
    "a probe line of text",
    "the quick brown fox jumps over the lazy dog",
    "Diffusion models write by hand",
    "MMXXVI",
    "pack my box with five dozen jugs",
    "hello world",
    "strokes and pen lifts",
    "Follow the White Rabbit",
]


def probe(teacher, student, text, teacher_steps: int, student_steps: int, device) -> dict:
    """The probe's JSON object for tokenized prompts `text` [B, L]."""
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.inference import generate

    style = torch.zeros((text.shape[0], 14, 1280))
    seq_len = infer_seq_len(text.shape[1])
    gen_kw = dict(seq_len=seq_len, diffusion_mode="ddim", schedule="halved", device=device)

    def run(model, n):
        gen = torch.Generator(device).manual_seed(PROBE_SEED)  # one x_T for all three
        return generate(model, text, style, gen, n_steps=n, **gen_kw)

    ref = run(teacher, teacher_steps)
    copy = run(teacher, student_steps)
    stud = run(student, student_steps)

    def mse(a, b):
        return float(((a[..., :2] - b[..., :2]) ** 2).mean())

    def per_row(a, b):
        return [round(float(v), 6) for v in ((a[..., :2] - b[..., :2]) ** 2).mean(dim=(1, 2))]

    out = {
        "teacher_steps": teacher_steps,
        "student_steps": student_steps,
        "n_prompts": int(text.shape[0]),
        "copy_vs_teacher_mse": mse(ref, copy),
        "student_vs_teacher_mse": mse(ref, stud),
        "distillation_wins": mse(ref, stud) < mse(ref, copy),
    }
    if text.shape[0] > 1:
        out["copy_per_prompt"] = per_row(ref, copy)
        out["student_per_prompt"] = per_row(ref, stud)
        wins = sum(s < c for s, c in zip(out["student_per_prompt"], out["copy_per_prompt"]))
        out["prompts_won"] = f"{wins}/{text.shape[0]}"
    return out


def prompt_batch(prompt: str, multi: bool) -> torch.Tensor:
    """[B, L] token ids: the 8 fixed prompts padded to one width, or one line."""
    from dhg_torch.data.tokenizer import Tokenizer

    tok = Tokenizer()
    if not multi:
        return torch.tensor([tok.encode(prompt)], dtype=torch.long)
    rows = [tok.encode(p) for p in MULTI_PROMPTS]
    width = max(len(r) for r in rows)
    return torch.tensor([r + [0] * (width - len(r)) for r in rows], dtype=torch.long)


def main(argv=None) -> dict:
    from dhg_torch import resolve_device
    from dhg_torch.checkpoint import resolve_checkpoint
    from dhg_torch.config import DLConfig, parse_cli_kwargs
    from dhg_torch.models.denoiser import DiffusionModel

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    device = resolve_device(kw.pop("device", "cuda"))
    teacher = kw.pop("teacher", None)
    student = kw.pop("student", None)
    if not teacher or not student:
        raise SystemExit("--teacher=<run dir> and --student=<run dir> are required")
    teacher_steps = int(kw.pop("teacher_steps", 60))
    prompt = kw.pop("prompt", PROBE_PROMPT)

    tmodel = DiffusionModel.load(resolve_checkpoint(teacher), device=device)
    scfg = DLConfig.load(f"{student}/config.yml")
    smodel = DiffusionModel.load(resolve_checkpoint(student), device=device)
    student_steps = int(
        kw.pop("student_steps", scfg.training_args.distilled_steps or teacher_steps // 2))
    text = prompt_batch(prompt, bool(kw.pop("multi", False)))
    out = probe(tmodel, smodel, text, teacher_steps, student_steps, device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
