"""Where a sampler call's time goes on the card: torch.profiler over one
generate call of the canonical bf16 model, summed by kernel and by stage.

    python -m dhg_torch.tools.profile_sampler [--batch 1 96 256] [--steps 10]
        [--out report.json] [--trace-dir DIR]

For each batch it prints: the wall time of the profiled call, the summed
device (CUDA kernel) time, the device idle share (1 - device time / wall
time), and the kernels with the most device time. Weights are random
(seed 0); seq_len 392 and 50 text tokens, as in chip_smoke.py. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _device_time_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_batch(model, batch: int, steps: int, trace_dir: str | None) -> dict:
    from dhg_torch.inference import generate

    rng = np.random.RandomState(batch)
    text = np.zeros((batch, 50), np.int64)
    text[:, :23] = rng.randint(2, 73, (batch, 23))
    text[:, 23] = 1
    style = rng.randn(batch, 14, 1280).astype(np.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def call():
        return generate(model, text, style, gen, seq_len=392, n_steps=steps, device="cuda")

    call()  # warm-up: kernel build, allocator, cuBLAS handles
    trace = os.path.join(trace_dir, f"sampler_b{batch}.json") if trace_dir else None
    return {"batch": batch, "steps": steps, **profile_call(call, trace)}


def profile_call(call, trace: str | None = None) -> dict:
    """One `call()` under torch.profiler, ended by a synchronise: its wall
    time, summed device time, idle share (1 - device / wall), kernel count
    (a replayed CUDA graph's kernels included) and the 12 kernels with the
    most device time; the Chrome trace to `trace` if given. Host operators
    are traced only for the trace: every returned figure comes from the
    device's kernels, and without host operators the profiler inflates the
    wall time less (so an untraced idle share reads lower than one taken
    with host operators traced) and post-processes an eager 60-step call
    (~56,000 kernels, ten times as many host operators) in seconds rather
    than half a minute."""
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if trace is not None:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace is not None:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=_device_time_us, reverse=True)
    device_us = sum(_device_time_us(e) for e in kernels)
    top = [{"kernel": e.key[:90], "calls": e.count, "device_ms": _device_time_us(e) / 1e3}
           for e in kernels[:12]]
    return {"wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
            "idle_share": 1.0 - device_us / 1e6 / wall,
            "n_kernel_launches": sum(e.count for e in kernels), "top": top}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 96, 256])
    ap.add_argument("--steps", type=int, default=10, help="strided sub-schedule length")
    ap.add_argument("--out")
    ap.add_argument("--trace-dir")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_sampler: needs a CUDA card")
    from dhg_torch.models.denoiser import DiffusionModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = DiffusionModel.from_config({"channels": 128}, dtype=torch.bfloat16, device="cuda")
    results = []
    for b in args.batch:
        r = profile_batch(model, b, args.steps, args.trace_dir)
        results.append(r)
        print(f"batch {b}, {r['steps']} steps: wall {r['wall_ms']:.1f} ms, device "
              f"{r['device_ms']:.1f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['n_kernel_launches']} kernel launches")
        for k in r["top"]:
            print(f"  {k['device_ms']:9.3f} ms  {k['calls']:6d}x  {k['kernel']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
