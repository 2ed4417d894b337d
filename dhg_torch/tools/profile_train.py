"""Where a training step's time goes on the card: torch.profiler over a few
steps of the canonical bf16 model at batch 96, with the train-path kernels
and with the plain-op path.

    python -m dhg_torch.tools.profile_train [--steps 3] [--batch 96]
        [--out report.json] [--trace-dir DIR]

For each path it prints the wall time of the profiled steps, the summed
device (CUDA kernel) time, the device idle share (1 - device time / wall
time), and the kernels with the most device time. The model and batch are
configs/best.yml's (channels 128, 2 attention layers, batch 96, T 480,
50 text tokens) on synthetic data; weights random (seed 0). Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from dhg_torch.tools.profile_sampler import _device_time_us

FLAGS = ("DHG_FUSED_ATTENTION", "DHG_FUSED_CONVBLOCK")


def best_config(work_dir, steps: int, batch: int = 96) -> dict:
    """configs/best.yml's model, batch and optimizer (over base.yml) on
    synthetic data, as a plain dict."""
    return {
        "experiment": {"name": "dhg_torch_train", "work_dir": str(work_dir), "seed": 0},
        "dataset_args": {"max_seq_len": 480, "max_text_len": 50},
        "training_args": {
            "steps": steps, "batch_size": batch, "max_files": 2 * batch,
            "warmup_steps": 10000, "clip_grad": 100.0, "clip_mode": "norm", "dropout": 0.0,
            "att_layers_num": 2, "channels": 128, "log_freq": 5, "save_freq": 10,
            "keep_checkpoints": 1, "ema_decay": 0.999, "compute_dtype": "bfloat16",
            "dataset": "synthetic"},
        "optimizer": {"type": "torch.optim.Adam",
                      "params": {"lr": 3e-4, "weight_decay": 1e-5, "betas": [0.9, 0.98]}},
    }


def profile_path(kernels: bool, steps: int, batch: int, trace_dir: str | None) -> dict:
    from dhg_torch.config import DLConfig
    from dhg_torch.train import Trainer

    for name in FLAGS:
        os.environ[name] = "1" if kernels else "0"
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(DLConfig(best_config(tmp, steps, batch)), device="cuda")
        trainer.train_step(trainer.draw(1))  # warm-up: kernel build, allocator, cuBLAS
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for c in range(2, steps + 2):
                trainer.train_step(trainer.draw(c))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    label = "kernels" if kernels else "plain"
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"train_{label}.json"))
    evts = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    evts.sort(key=_device_time_us, reverse=True)
    device_us = sum(_device_time_us(e) for e in evts)
    top = [{"kernel": e.key[:90], "calls": e.count, "device_ms": _device_time_us(e) / 1e3}
           for e in evts[:15]]
    return {"path": label, "steps": steps, "batch": batch, "wall_ms": wall * 1e3,
            "device_ms": device_us / 1e3, "idle_share": 1.0 - device_us / 1e6 / wall,
            "n_kernel_launches": sum(e.count for e in evts), "top": top}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--out")
    ap.add_argument("--trace-dir")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA card")
    results = []
    for kernels in (False, True):
        r = profile_path(kernels, args.steps, args.batch, args.trace_dir)
        results.append(r)
        print(f"{r['path']}: {r['steps']} steps at batch {r['batch']}: wall {r['wall_ms']:.1f} ms, "
              f"device {r['device_ms']:.1f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['n_kernel_launches']} kernel launches")
        for k in r["top"]:
            print(f"  {k['device_ms']:9.3f} ms  {k['calls']:6d}x  {k['kernel']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
