"""Where a sampler step's milliseconds go, stage by stage (port of
dhg/tools/profile_stages.py).

    python -m dhg_torch.tools.profile_stages [--batch=96] [--prompt_len=24] [--device=cpu]

Each stage is timed as one program of N_STEPS (60) calls of its body, each
on the last's output, the same sequential structure as the sampler:

  enc1       ConvBlock @ T, c1
  enc2_enc3  ConvBlock + EncoderLayer @ T/2, c2
  enc4_enc5  ConvBlock + EncoderLayer @ T/4, c3
  att_stack  att_dense + N x EncoderLayer @ T/8, 2 c2
  decoder    three ConvBlocks + skip convs + upsamples @ T/4..T
  full       the whole denoise step

'full - sum(stages)' approximates the glue (pools, heads, residual adds).
The stages run as the sampler runs them: the canonical model (random,
seed 0, bf16), the batch-1 FiLM coefficients and the precomputed K/V of
one noise level (sigma 0.7), so att_stack goes through fused_bottleneck
and, at 8 <= batch <= 128, enc2_enc3 / enc4_enc5 through
fused_encoder_layer (with DHG_FUSED_T4=1, `full` takes fused_unet_t4);
`kernels` reports the kernel launches of one run of each stage's body.

dhg times each stage as one jitted 60-step lax.scan, dispatch outside it.
On the card each stage's loop is likewise one captured CUDA graph on its
static x0 (core/graphs.py CapturedBody; the kernels' launches inside it
counted at each replay), and `ms_per_step`, `stage_sum_ms`, `glue_ms` and
`pct_of_full` are the fastest of ITERS replays under CUDA events; the same
loop run eagerly (60 launches of the body from the host) goes beside them
under `eager_ms_per_step`. On the CPU there is no graph: both are the
eager loop on the host clock. Prints one JSON object (dhg's keys, plus
`kernels` and `eager_ms_per_step`).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from dhg_torch.tools.common import backend, random_inputs, tool_device

N_STEPS = 60
ITERS = 5


def stage_loop(body):
    """One stage's program: N_STEPS calls of `body`, each on the last's
    output (dhg's 60-step lax.scan)."""

    def run(x):
        for _ in range(N_STEPS):
            x = body(x)
        return x

    return run


def _timed(run, device) -> float:
    """Seconds per step: the fastest of ITERS calls of `run` (one N_STEPS
    loop each), after one warm-up call; CUDA events around each call on the
    card, the host clock on the CPU."""
    run()  # warm-up
    times = []
    for _ in range(ITERS):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return min(times) / N_STEPS


def build_stages(batch: int = 96, prompt_len: int = 24, device: str | torch.device = "cuda"):
    """(model, {stage: (body, x0)}): the canonical model and each stage's
    one-step body on its start x0, as the sampler runs them. Call the
    bodies under torch.inference_mode()."""
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.ops.basic import create_padding_mask
    from dhg_torch.ops.conv import avg_pool_1d, upsample_nearest_1d
    from dhg_torch.tools.common import CANONICAL

    dev = torch.device(device)
    dt = torch.bfloat16
    seq_len = infer_seq_len(prompt_len)
    model = DiffusionModel.from_config(CANONICAL, dtype=dt, device=dev, seed=0)
    c1, c2, c3 = model.c1, model.c2, model.c3
    text, style = random_inputs(batch, dev)
    stages = {}
    # The sampler's hoisted context at one level: batch-1 sigma embedding and FiLM.
    with torch.inference_mode():
        se = model.embed_sigma(torch.full((1, 1), 0.7, device=dev))
        films = model.precompute_film(se)
        kvs = model.precompute_cross_kv(model.encode_cond_tail(model.encode_cond_pre(text, style),
                                                               se), se)
    mask = create_padding_mask(text)
    cf = films["conv"]

    def full_body(x):
        eps, _ = model.denoise(x, None, None, mask, kvs=kvs, films=films)
        return (0.99 * x - 0.01 * eps).to(x.dtype)

    stages["full"] = (full_body, torch.zeros((batch, seq_len, 2), device=dev))
    stages["enc1"] = (lambda h: 0.99 * model.enc1(h, None, coeffs=cf[0]),
                      torch.zeros((batch, seq_len, c1), dtype=dt, device=dev))

    def enc23_body(h):
        h = model.enc2(h, None, coeffs=cf[1])
        return 0.99 * model._encode_enc3(h, None, None, mask, kvs, films)[..., :c1]

    stages["enc2_enc3"] = (enc23_body, torch.zeros((batch, seq_len // 2, c1), dtype=dt,
                                                    device=dev))
    stages["enc4_enc5"] = (
        lambda h: 0.99 * model._encode_t4(h, None, None, mask, kvs, films)[..., :c2],
        torch.zeros((batch, seq_len // 4, c2), dtype=dt, device=dev))
    stages["att_stack"] = (
        lambda h: 0.99 * model._bottleneck(h, None, None, mask, kvs, films)[..., :c3],
        torch.zeros((batch, seq_len // 8, c3), dtype=dt, device=dev))
    h1 = torch.zeros((batch, seq_len, c1), dtype=dt, device=dev)
    h2 = torch.zeros((batch, seq_len // 2, c2), dtype=dt, device=dev)
    h3 = torch.zeros((batch, seq_len // 4, c3), dtype=dt, device=dev)

    def dec_body(xb):
        h = model.dec3(upsample_nearest_1d(xb) + model.skip_conv3(h3, dt), None, coeffs=cf[3])
        h = model.dec2(upsample_nearest_1d(h) + model.skip_conv2(h2, dt), None, coeffs=cf[4])
        h = model.dec1(upsample_nearest_1d(h) + model.skip_conv1(h1, dt), None, coeffs=cf[5])
        pooled = avg_pool_1d(avg_pool_1d(avg_pool_1d(h)))  # [B, T/8, c1]
        return 0.99 * pooled.repeat(1, 1, (2 * c2) // c1)  # back to 2 c2

    stages["decoder"] = (dec_body, torch.zeros((batch, seq_len // 8, 2 * c2), dtype=dt,
                                                device=dev))
    return model, stages


def profile(batch: int = 96, prompt_len: int = 24, device: str | torch.device = "cuda") -> dict:
    from dhg_torch.kernels import fused_bottleneck as fk

    dev = torch.device(device)
    eager, replayed, kernels = {}, {}, {}
    model, stages = build_stages(batch, prompt_len, dev)
    seq_len = stages["full"][1].shape[1]
    with torch.inference_mode():
        for name, (body, x0) in stages.items():
            fk.reset_launch_counts()
            body(x0)
            kernels[name] = {k: v for k, v in fk.launches.items() if v}
            loop = stage_loop(body)
            eager[name] = _timed(lambda: loop(x0), dev)
            if dev.type == "cuda":
                from dhg_torch.core.graphs import CapturedBody

                graph = CapturedBody(loop, (x0,), (model,), dev)
                graph.run()  # the loop eagerly on a side stream, then its capture
                replayed[name] = _timed(graph.run, dev)
                del graph

    results = replayed if dev.type == "cuda" else eager
    staged = sum(v for k, v in results.items() if k != "full")
    return {
        "batch": batch,
        "seq_len": seq_len,
        "backend": backend(dev),
        "ms_per_step": {k: round(v * 1e3, 4) for k, v in results.items()},
        "stage_sum_ms": round(staged * 1e3, 4),
        "glue_ms": round((results["full"] - staged) * 1e3, 4),
        "pct_of_full": {k: round(100 * v / results["full"], 1)
                        for k, v in results.items() if k != "full"},
        "eager_ms_per_step": {k: round(v * 1e3, 4) for k, v in eager.items()},
        "kernels": kernels,
    }


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    report = profile(batch=int(kw.get("batch", 96)), prompt_len=int(kw.get("prompt_len", 24)),
                     device=dev)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
