"""The sampler's batch x hoist grid (port of dhg/tools/bench_hoist.py).

    python -m dhg_torch.tools.bench_hoist [--batches=256,512,768]
        [--hoist=full,compact] [--device=cpu]

The full hoist computes every level's cross-attention K/V before the loop
(its context grows with the batch: ~2,432 bf16 values per text token per
level, ~3.7 GB at batch 256 with 50 tokens, ~11 GB at 768); the compact
hoist keeps the conditioning memory and rebuilds each step's K/V in the
loop (dhg_torch/inference.py::generate). This times both over the batch:
two warm-up calls (on CUDA the eager call and the capture of generate's
graph), then `iters` 60-step calls, replays, queued and one synchronise.
The model is random (seed 0, the canonical widths, bf16), seq_len 392,
50 text tokens, mode "new".

Prints one JSON object per cell (dhg's keys, plus `backend`), then
`BEST: <the fastest cell>`. A cell that runs out of device memory is
reported with `error` and `detail` as dhg's is; no other failure is
caught.
"""

from __future__ import annotations

import json
import sys

import torch

from dhg_torch.tools.common import (backend, random_inputs, seconds_per_call, tool_device,
                                    warm_up)

N_STEPS = 60
SEQ_LEN = 392  # a 24-token prompt's bucket, as chip_smoke.py


def measure(batch: int, hoist: str, iters: int = 4, device: str | torch.device = "cuda") -> dict:
    from dhg_torch.inference import generate
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools.common import CANONICAL

    dev = torch.device(device)
    model = DiffusionModel.from_config(CANONICAL, dtype=torch.bfloat16, device=dev, seed=0)
    text, style = random_inputs(batch, dev)

    def sample(i):
        return generate(model, text, style, torch.Generator(dev).manual_seed(7 + i),
                        seq_len=SEQ_LEN, n_steps=N_STEPS, hoist=hoist, device=dev)

    try:
        warm_up(sample, dev)
    except torch.cuda.OutOfMemoryError as e:  # the out-of-memory cell is the point
        error = {"batch": batch, "hoist": hoist, "error": type(e).__name__,
                 "detail": str(e).split("\n")[0][:200], "backend": backend(dev)}
    else:
        error = None
    if error is not None:
        del model, text, style
        torch.cuda.empty_cache()
        return error
    sec = seconds_per_call(sample, iters, dev)
    return {
        "batch": batch,
        "hoist": hoist,
        "ms_per_call": round(sec * 1000, 1),
        "ms_per_step": round(sec * 1000 / N_STEPS, 3),
        "denoise_steps_per_sec": round(N_STEPS * batch / sec),
        "backend": backend(dev),
    }


def main(argv=None) -> list[dict]:
    from dhg_torch.config import parse_cli_kwargs

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    batches = [int(b) for b in str(kw.get("batches", "256,512,768")).split(",")]
    hoists = str(kw.get("hoist", "full,compact")).split(",")
    grid = []
    for b in batches:
        for hoist in hoists:
            r = measure(b, hoist, device=dev)
            print(json.dumps(r), flush=True)
            grid.append(r)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    best = max((g for g in grid if "error" not in g),
               key=lambda g: g["denoise_steps_per_sec"], default=None)
    print("BEST:", json.dumps(best), flush=True)
    return grid


if __name__ == "__main__":
    main()
