"""Parallel-in-time (Jacobi) DDIM sampling against the sequential loop
(port of dhg/tools/eval_parallel_sampler.py).

    python -m dhg_torch.tools.eval_parallel_sampler [--experiment_path=<run dir>]
        [--batch=1] [--tokens=24] [--sweeps=4,8,12,16] [--iters=20] [--device=cpu]

For each sweep count k: ms per call (N calls queued, one synchronise) and
the stroke MSE of the k-sweep estimate against the SEQUENTIAL DDIM
trajectory from the same x_T (the fixed point). The sequential baseline is
the compact-hoist `generate(diffusion_mode="ddim")`. Every k's MSE comes
from ONE return_all_sweeps run at max(sweeps).

The parallel sampler calls the model's full forward at batch n*B with one
sigma per row (conditioning tiled), so the sampler kernels' gate is closed
(they need the sampler's batch-1 FiLM): the tool prints their launch
counts over the parallel runs, 0 on this path. The model is random (seed
0, the canonical widths, bf16) or --experiment_path's checkpoint in
float32. Prints dhg's table; `main` returns the same numbers as a dict.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dhg_torch.tools.common import backend, seconds_per_call, tool_device

SEED = 42  # dhg's PRNGKey(42)
SAMPLER_KERNELS = ("fused_bottleneck", "fused_encoder_layer", "fused_unet_t4")


def _timed_sustained(fn, iters: int, device) -> float:
    fn(0)  # warm-up
    fn(999)
    return seconds_per_call(lambda i: fn(i + 1), iters, device)


def prompts(batch: int, tokens: int, device):
    """dhg's inputs: `tokens` ids in 2..72 from RandomState(0), EOS, zero
    padding to 50; zero style."""
    rng = np.random.RandomState(0)
    text = np.zeros((batch, 50), np.int64)
    text[:, :tokens] = rng.randint(2, 73, size=(batch, tokens))
    text[:, tokens] = 1
    return torch.from_numpy(text).to(device), torch.zeros((batch, 14, 1280), device=device)


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs
    from dhg_torch.core.parallel_sampling import parallel_ddim_sample
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.inference import generate
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.tools.common import load_model

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    batch = int(kw.get("batch", 1))
    tokens = int(kw.get("tokens", 24))
    iters = int(kw.get("iters", 20))
    sweep_list = [int(s) for s in str(kw.get("sweeps", "4,8,12,16")).split(",") if s.strip()]
    seq_len = infer_seq_len(tokens)
    text, style = prompts(batch, tokens, dev)
    model = load_model(kw, dev)

    def gen(i):
        return torch.Generator(dev).manual_seed(SEED + i)

    # -- sequential baseline: the compact-hoist DDIM sampler -------------------
    def seq_fn(i):
        return generate(model, text, style, gen(i), seq_len=seq_len, diffusion_mode="ddim",
                        device=dev)

    t_seq = _timed_sustained(seq_fn, iters, dev)
    seq_out = seq_fn(0).cpu().numpy()
    print(f"backend {backend(dev)}")
    print(f"sequential ddim  batch={batch} T={seq_len}: {t_seq * 1e3:8.1f} ms/call")

    # -- parallel: the full forward, conditioning tiled to n*B -----------------
    def denoise_any(x, sigma):
        reps = x.shape[0] // batch
        return model(x, text.repeat(reps, 1), sigma, style.repeat(reps, 1, 1))

    def par_fn(k, i, all_sweeps=False):
        return parallel_ddim_sample(denoise_any, batch, seq_len, sweeps=k, generator=gen(i),
                                    return_all_sweeps=all_sweeps, device=dev)

    fk.reset_launch_counts()
    k_max = max(sweep_list)
    _, ests = par_fn(k_max, 0, all_sweeps=True)
    ests = ests.cpu().numpy()
    mses = ((ests[..., :2] - seq_out[None, ..., :2]) ** 2).mean(axis=(1, 2, 3))

    rows = []
    print(f"{'sweeps':>6} {'ms/call':>9} {'vs seq':>7} {'stroke MSE':>11}")
    for k in sweep_list:
        t_par = _timed_sustained(lambda i, k=k: par_fn(k, i), iters, dev)
        rows.append({"sweeps": k, "ms_per_call": t_par * 1e3, "vs_seq": t_seq / t_par,
                     "stroke_mse": float(mses[k - 1])})
        print(f"{k:>6} {t_par * 1e3:>9.1f} {t_seq / t_par:>6.2f}x {mses[k - 1]:>11.3e}")
    launches = {name: fk.launches[name] for name in SAMPLER_KERNELS}
    print(f"sampler-kernel launches in the parallel runs: {launches} (expected 0: the full "
          f"forward with per-row sigma closes their gate)")
    return {"backend": backend(dev), "batch": batch, "seq_len": seq_len,
            "sequential_ms": t_seq * 1e3, "rows": rows, "sampler_kernel_launches": launches}


if __name__ == "__main__":
    main()
