"""Batched sampling sweep: a batch x diffusion-steps grid (port of
dhg/tools/sweep.py).

    python -m dhg_torch.tools.sweep [--batches=16,96,256] [--steps=20,30,60]
        [--guidance=1.0] [--prompt_len=24] [--experiment_path=<run dir>] [--device=cpu]

Prints one JSON line per cell: batch, n_steps, guidance, seq_len, wall
time (the fastest of 3 calls, each ended by a synchronise, after one
warm-up call), denoise steps/s, amortised ms per line, backend. Each cell
samples mode "new" on dhg's sweep schedule, the n_steps-level table
get_beta_set(n_steps), through the compact-hoist sampler. Random weights
(seed 0, the canonical widths, bf16; throughput does not depend on the
weights), or --experiment_path's checkpoint in float32.
"""

from __future__ import annotations

import json
import sys

import torch

from dhg_torch.tools.common import backend, random_inputs, seconds_per_call, tool_device


def main(argv=None) -> list[dict]:
    from dhg_torch.config import parse_cli_kwargs
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.core.schedule import get_beta_set
    from dhg_torch.inference import _sample
    from dhg_torch.tools.common import load_model

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    batches = [int(b) for b in str(kw.get("batches", "16,96,256")).split(",")]
    steps_list = [int(s) for s in str(kw.get("steps", "20,30,60")).split(",")]
    guidance_list = [float(g) for g in str(kw.get("guidance", "1.0")).split(",")]
    seq_len = infer_seq_len(int(kw.get("prompt_len", 24)))
    model = load_model(kw, dev)
    if dev.type == "cuda":  # generate's precision: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    rows = []
    for batch in batches:
        text, style = random_inputs(batch, dev)
        for n_steps in steps_list:
            beta = get_beta_set(n_steps).to(dev)
            for g in guidance_list:
                gs = None if g == 1.0 else g

                def run(i):
                    with torch.inference_mode():
                        return _sample(model, text, style, torch.Generator(dev).manual_seed(4 + i),
                                       seq_len, beta, "new", gs, 1.0, None, None, dev)

                run(-1)  # warm-up
                t = min(seconds_per_call(lambda _, i=i: run(i), 1, dev) for i in range(3))
                row = {"batch": batch, "n_steps": n_steps, "guidance": g, "seq_len": seq_len,
                       "time_s": round(t, 4),
                       "denoise_steps_per_sec": round(n_steps * batch / t, 1),
                       "ms_per_line": round(1000 * t / batch, 3), "backend": backend(dev)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
