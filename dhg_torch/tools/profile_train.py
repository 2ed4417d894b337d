"""Profile the train step (port of dhg/tools/profile_train.py): FLOPs for
one step, steps/s through the production chunk path, MFU, and a
forward/backward split from the same draws.

    python -m dhg_torch.tools.profile_train [--batch=96] [--steps_per_window=96]
        [--trace_dir=DIR] [--device=cpu]

`profile` prints one JSON dict with dhg's keys:

  1. flops_per_step: one Trainer.train_step counted by
     torch.utils.flop_counter.FlopCounterMode on a throwaway trainer with
     both train flags off. The counter counts products (mm, bmm, conv,
     attention) and not elementwise work, where dhg's XLA cost analysis
     counts elementwise work too, so the two figures differ by that much.
     Counted on the plain path, it is the same work whichever
     implementation runs: FlopCounterMode does not see inside the kernels'
     autograd Functions.
  2. steps_per_sec: the median of 3 windows of ceil(steps_per_window / 16)
     16-step Trainer.train_chunk calls (on CUDA each step replays the
     captured step graph), after two warm-up windows; a host read of the
     last row ends each window.
  3. achieved_tflops and mfu_vs_h100_bf16_peak (989 TFLOP/s, the H100 SXM's
     dense bf16 peak; dhg's key names the v5e's). The HBM fields are null:
     the port does not measure the bytes of a step.
  4. fwd_only_steps_per_sec: the same windows of the step's forward alone
     (Trainer.forward_chunk: the step's draws, dropout and loss at fixed
     params, no grad, no update; on CUDA replayed from its own captured
     graph), and bwd_plus_update_ms = ms_per_step - fwd_only_ms.
  5. with --trace_dir, a torch.profiler Chrome trace of one window of
     train_chunk (train_chunks_<first>-<last>.json).

The config is dhg's: smoke.yml over base.yml at the given batch (channels
128, 2 attention layers, T 480, 50 text tokens, bf16, synthetic data),
random weights from the config's seed. DHG_FUSED_ATTENTION and
DHG_FUSED_CONVBLOCK choose the step's attention and ConvBlock route, as in
training. Runs on the card unless --device=cpu.

    python -m dhg_torch.tools.profile_train --kernel_table [--steps=3] [--batch=96]
        [--distill] [--out=report.json] [--trace_dir=DIR]

--kernel_table instead profiles a few eager steps of configs/best.yml's
model with torch.profiler, with the train-path kernels and with the
plain-op path (--distill: distillation steps, dhg_torch.distill.Distiller
60 -> 30 in float32, as the distill CLI runs, from a teacher with the same
random weights). For each path it prints the wall time of the profiled
steps, the summed device (CUDA kernel) time, the device idle share
(1 - device time / wall time), and the kernels with the most device time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

from dhg_torch.tools.profile_sampler import _device_time_us

FLAGS = ("DHG_FUSED_ATTENTION", "DHG_FUSED_CONVBLOCK")
H100_BF16_PEAK_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
CHUNK = 16  # steps of one train_chunk, as dhg's chunk program


def profile_config(batch: int) -> dict:
    """dhg's profile config: configs/smoke.yml over base.yml at `batch`,
    256 synthetic lines."""
    from dhg_torch.config import fit_config

    return fit_config(config="smoke.yml",
                      **{"training_args.batch_size": batch, "training_args.max_files": 256})


@contextmanager
def train_flags(value: str):
    """Both train flags set to `value` inside, restored after."""
    saved = {name: os.environ.get(name) for name in FLAGS}
    os.environ.update({name: value for name in FLAGS})
    try:
        yield
    finally:
        for name, v in saved.items():
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v


def step_flops(cfg, device) -> float:
    """FLOPs of one train_step of a throwaway trainer from `cfg` (its seed,
    step 1's draws), both train flags off: FlopCounterMode's count of the
    products, forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from dhg_torch.train import Trainer

    with train_flags("0"):
        trainer = Trainer(cfg, device=device)
        d = trainer.draw(1)
        with FlopCounterMode(display=False) as counter:
            trainer.train_step(d)
    return float(counter.get_total_flops())


def profile(batch: int = 96, steps_per_window: int = 96, trace_dir: str | None = None,
            device="cuda") -> dict:
    """dhg's train-step profile on `device` (see the module docstring);
    prints the result as one JSON line and returns it."""
    from dhg_torch import resolve_device
    from dhg_torch.config import DLConfig
    from dhg_torch.train import Trainer

    dev = resolve_device(device)
    cfg = DLConfig(profile_config(batch))
    trainer = Trainer(cfg, device=dev)
    trainer.load_dataset()
    steps = -(-steps_per_window // CHUNK) * CHUNK
    flops = step_flops(cfg, dev)

    def run(base: int) -> None:
        for lo in range(base, base + steps, CHUNK):
            rows = trainer.train_chunk(lo, CHUNK)
        rows[-1].tolist()

    def window_rates(fn) -> list[float]:
        rates = []
        for trial in range(3):
            t0 = time.perf_counter()
            fn(trial)
            rates.append(steps / (time.perf_counter() - t0))
        return rates

    try:
        run(10_000)  # the step graph's capture
        run(20_000)
        rates = window_rates(lambda trial: run(trial * steps))
        sps = float(np.median(rates))
        # The forward alone, on steps 0 .. steps - 1's draws at fixed params.
        trainer.forward_chunk(0, steps)[-1].tolist()  # the forward graph's capture
        fwd_sps = float(np.median(window_rates(
            lambda trial: trainer.forward_chunk(0, steps)[-1].tolist())))
        if trace_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                run(50_000)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, f"train_chunks_{50_000}-{50_000 + steps - 1}.json"))
    finally:
        # Their pools back now: each graph refers to the trainer.
        trainer.graph = trainer.forward_graph = None

    ms_per_step = 1000.0 / sps
    result = {
        "batch": batch,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "steps_per_sec": round(sps, 2),
        "rate_trials": [round(r, 2) for r in rates],
        "ms_per_step": round(ms_per_step, 3),
        "samples_per_sec": round(sps * batch, 0),
        "flops_per_step": flops,
        "hbm_bytes_per_step": None,
        "achieved_tflops": round(flops * sps / 1e12, 2),
        "mfu_vs_h100_bf16_peak": round(flops * sps / H100_BF16_PEAK_FLOPS, 4),
        "hbm_bw_gbps": None,
        "hbm_bw_util": None,
        "fwd_only_steps_per_sec": round(fwd_sps, 2),
        "fwd_only_ms": round(1000.0 / fwd_sps, 3),
        "bwd_plus_update_ms": round(ms_per_step - 1000.0 / fwd_sps, 3),
        "trace_dir": trace_dir,
    }
    print(json.dumps(result), flush=True)
    return result


# -- --kernel_table: torch.profiler over a few eager steps ---------------------


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


def train_step_fn(cfg):
    """step(c): Trainer.train_step on step c's draws."""
    from dhg_torch.train import Trainer

    trainer = Trainer(cfg, device="cuda")
    return lambda c: trainer.train_step(trainer.draw(c))


def distill_step_fn(cfg):
    """step(c): one Distiller step (60 -> 30, float32 as the distill CLI)."""
    from dhg_torch.config import DLConfig, update_config
    from dhg_torch.data.pipeline import DeviceDataset
    from dhg_torch.distill import Distiller
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.train import load_cache

    cfg = DLConfig(update_config(cfg.to_dict(), {"training_args.compute_dtype": "float32"}))
    teacher = DiffusionModel.from_config(cfg.training_args, device="cuda").state_dict()
    d = Distiller(cfg, teacher, device="cuda")
    data = DeviceDataset.from_cache(load_cache(cfg, "train", "cuda"), "cuda")
    gen = torch.Generator("cuda").manual_seed(99)
    return lambda c: d.step(data.arrays, d.draw(gen, data.size, data.strokes.shape[1]))


def profile_path(kernels: bool, steps: int, batch: int, trace_dir: str | None,
                 distill: bool = False) -> dict:
    from torch.profiler import ProfilerActivity

    from dhg_torch.config import DLConfig

    for name in FLAGS:
        os.environ[name] = "1" if kernels else "0"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = DLConfig(best_config(tmp, steps, batch))
        step = (distill_step_fn if distill else train_step_fn)(cfg)
        step(1)  # warm-up: kernel build, allocator, cuBLAS
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for c in range(2, steps + 2):
                step(c)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    label = ("distill " if distill else "") + ("kernels" if kernels else "plain")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"train_{label.replace(' ', '_')}.json"))
    evts = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    evts.sort(key=_device_time_us, reverse=True)
    device_us = sum(_device_time_us(e) for e in evts)
    top = [{"kernel": e.key[:90], "calls": e.count, "device_ms": _device_time_us(e) / 1e3}
           for e in evts[:15]]
    return {"path": label, "steps": steps, "batch": batch, "wall_ms": wall * 1e3,
            "device_ms": device_us / 1e3, "idle_share": 1.0 - device_us / 1e6 / wall,
            "n_kernel_launches": sum(e.count for e in evts), "top": top}


def kernel_table(steps: int, batch: int, trace_dir: str | None, distill: bool,
                 out: str | None) -> list[dict]:
    """profile_path with the kernels off, then on; prints each path's table."""
    results = []
    for kernels in (False, True):
        r = profile_path(kernels, steps, batch, trace_dir, distill)
        results.append(r)
        print(f"{r['path']}: {r['steps']} steps at batch {r['batch']}: wall {r['wall_ms']:.1f} ms, "
              f"device {r['device_ms']:.1f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['n_kernel_launches']} kernel launches")
        for k in r["top"]:
            print(f"  {k['device_ms']:9.3f} ms  {k['calls']:6d}x  {k['kernel']}")
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "results": results}, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--steps_per_window", type=int, default=96)
    ap.add_argument("--trace_dir", "--trace-dir", dest="trace_dir")
    ap.add_argument("--device", default="cuda", help="cpu runs profile on the plain CPU path")
    ap.add_argument("--kernel_table", action="store_true",
                    help="torch.profiler's kernel table of a few eager steps instead")
    ap.add_argument("--steps", type=int, help="--kernel_table: steps profiled (default 3)")
    ap.add_argument("--distill", action="store_true", help="--kernel_table: distillation steps")
    ap.add_argument("--out", help="--kernel_table: also write the tables as JSON here")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not args.kernel_table:
        if args.steps is not None or args.distill or args.out:
            ap.error("--steps, --distill and --out belong to --kernel_table")
        return profile(batch=args.batch, steps_per_window=args.steps_per_window,
                       trace_dir=args.trace_dir, device=args.device)
    if not torch.cuda.is_available():
        sys.exit("profile_train --kernel_table: needs a CUDA card")
    return kernel_table(args.steps or 3, args.batch, args.trace_dir, args.distill, args.out)


if __name__ == "__main__":
    main()
