"""Fidelity and speed of strided fewer-step sampling (port of
dhg/tools/eval_fewer_steps.py).

    python -m dhg_torch.tools.eval_fewer_steps --experiment_path=<run dir> \
        [--batch=96] [--prompt_len=24] [--steps=30,20,15,10] \
        [--diffusion_mode=new] [--device=cpu]

generate(n_steps=k) walks a coarsened beta table whose cumprod(1 - beta)
hits k of the canonical 60 alpha_bar levels (strided DDPM), so a line
costs k denoiser calls instead of 60. For each k, against the 60-step
sampler from the same generator seed:

  * stroke-delta MSE, max drift and pen-flip rate. In "new"/"standard" the
    strided run draws a different number of noise samples, so this is
    closeness of the endpoint, not a step-for-step match; with
    --diffusion_mode=ddim both start from the same x_T and inject no noise,
    so the MSE is the discretisation error;
  * ms per call and lines/s: N calls queued, one synchronise.

The model is the run's checkpoint in float32, as dhg's load_model loads
it. Prints one JSON object (dhg's keys, plus `backend`).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dhg_torch.tools.common import backend, random_inputs, seconds_per_call, tool_device


def evaluate_fewer_steps(
    model,
    batch: int = 96,
    prompt_len: int = 24,
    steps_values=(30, 20, 15, 10),
    seed: int = 0,
    diffusion_mode: str = "new",
    iters: int = 4,
    device: str | torch.device = "cuda",
) -> dict:
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.inference import generate

    dev = torch.device(device)
    seq_len = infer_seq_len(prompt_len)
    text, style = random_inputs(batch, dev, prompt_len)

    def call(n_steps, s):
        gen = torch.Generator(dev).manual_seed(s)
        return generate(model, text, style, gen, seq_len=seq_len, diffusion_mode=diffusion_mode,
                        n_steps=n_steps, device=dev)

    def timed(n_steps):
        out = call(n_steps, seed).cpu().numpy()  # warm-up, and the result for fidelity
        return out, seconds_per_call(lambda i: call(n_steps, seed + 1 + i), iters, dev)

    exact, sec60 = timed(None)
    rows = []
    for k in steps_values:
        approx, sec = timed(int(k))
        d_xy = approx[..., :2] - exact[..., :2]
        rows.append({
            "n_steps": int(k),
            "stroke_mse": float(np.mean(d_xy ** 2)),
            "stroke_max_abs": float(np.abs(d_xy).max()),
            "pen_flip_rate": float(np.mean(np.round(approx[..., 2]) != np.round(exact[..., 2]))),
            "ms_per_call": round(sec * 1000, 1),
            "lines_per_sec": round(batch / sec, 1),
            "speedup_vs_60": round(sec60 / sec, 2),
        })
    return {"batch": batch, "seq_len": seq_len, "mode": diffusion_mode, "backend": backend(dev),
            "ms_per_call_60": round(sec60 * 1000, 1), "rows": rows}


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs
    from dhg_torch.tools.common import load_model

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    if not kw.get("experiment_path"):
        raise SystemExit("--experiment_path=<run dir> is required")
    steps = [int(x) for x in str(kw.get("steps", "30,20,15,10")).split(",")]
    report = evaluate_fewer_steps(
        load_model(kw, dev),
        batch=int(kw.get("batch", 96)),
        prompt_len=int(kw.get("prompt_len", 24)),
        steps_values=steps,
        diffusion_mode=str(kw.get("diffusion_mode", "new")),
        device=dev,
    )
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
