"""What the experimental encoder_reuse sampler costs in fidelity (port of
dhg/tools/eval_encoder_reuse.py).

    python -m dhg_torch.tools.eval_encoder_reuse --experiment_path=<run dir> \
        [--batch=96] [--prompt_len=24] [--reuse=2,3,4] [--diffusion_mode=new] \
        [--device=cpu]

encoder_reuse=k runs the U-Net's encoder half only every k-th step (Li et
al., "Faster Diffusion", arXiv:2312.09608) and decodes cached skip
features in between. This samples the same prompts from the same
generator seed at k = 1 (exact) and at each requested k, so both runs
draw the same noise and the difference is the approximation alone, and
reports per k:

  * stroke-delta MSE against the exact run (the 1e-3 parity bar),
  * the pen-lift flip rate (rounded pen bits that differ),
  * max |delta| drift.

The model is the run's checkpoint in float32, as dhg's load_model loads
it. Prints one JSON object (dhg's keys, plus `backend`).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dhg_torch.tools.common import backend, random_inputs, tool_device


def evaluate_reuse(
    model,
    batch: int = 96,
    prompt_len: int = 24,
    reuse_values=(2, 3, 4),
    seed: int = 0,
    diffusion_mode: str = "new",
    device: str | torch.device = "cuda",
) -> dict:
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.inference import generate

    dev = torch.device(device)
    seq_len = infer_seq_len(prompt_len)
    text, style = random_inputs(batch, dev, prompt_len)  # zero tail: a real padding mask

    def run(k):
        gen = torch.Generator(dev).manual_seed(seed)
        return generate(model, text, style, gen, seq_len=seq_len, diffusion_mode=diffusion_mode,
                        encoder_reuse=k, device=dev).cpu().numpy()

    exact = run(None)
    rows = []
    for k in reuse_values:
        approx = run(int(k))
        d_xy = approx[..., :2] - exact[..., :2]
        mse = float(np.mean(d_xy ** 2))
        rows.append({
            "reuse_every": int(k),
            "stroke_mse": mse,
            "stroke_max_abs": float(np.abs(d_xy).max()),
            "pen_flip_rate": float(np.mean(np.round(approx[..., 2]) != np.round(exact[..., 2]))),
            "under_1e-3_bar": bool(mse <= 1e-3),
        })
    return {"batch": batch, "seq_len": seq_len, "mode": diffusion_mode, "backend": backend(dev),
            "rows": rows}


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs
    from dhg_torch.tools.common import load_model

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    if not kw.get("experiment_path"):
        raise SystemExit("--experiment_path=<run dir> is required")
    reuse = [int(x) for x in str(kw.get("reuse", "2,3,4")).split(",")]
    report = evaluate_reuse(
        load_model(kw, dev),
        batch=int(kw.get("batch", 96)),
        prompt_len=int(kw.get("prompt_len", 24)),
        reuse_values=reuse,
        diffusion_mode=str(kw.get("diffusion_mode", "new")),
        device=dev,
    )
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
