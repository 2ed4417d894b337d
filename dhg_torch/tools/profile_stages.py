"""Where a sampler step's milliseconds go, stage by stage (port of
dhg/tools/profile_stages.py).

    python -m dhg_torch.tools.profile_stages [--batch=96] [--prompt_len=24] [--device=cpu]

Each stage is timed as N_STEPS (60) launches of its body in a loop, the
same sequential structure as the sampler, so launch and host effects are
in the figure:

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
`kernels` reports the kernel launches of one run of each stage. Times are
CUDA events around each 60-launch loop on the card (the host clock on the
CPU), the fastest of ITERS loops. Prints one JSON object (dhg's keys, plus
`kernels`).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from dhg_torch.tools.common import backend, random_inputs, tool_device

N_STEPS = 60
ITERS = 5


def _timed_loop(body, x0, device) -> float:
    """Seconds per step: the fastest of ITERS loops of N_STEPS body calls."""

    def run():
        x = x0
        for _ in range(N_STEPS):
            x = body(x)
        return x

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


def profile(batch: int = 96, prompt_len: int = 24, device: str | torch.device = "cuda") -> dict:
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.kernels import fused_bottleneck as fk
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
    with torch.inference_mode():
        # The sampler's hoisted context at one level: batch-1 sigma embedding and FiLM.
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
        results, kernels = {}, {}
        for name, (body, x0) in stages.items():
            fk.reset_launch_counts()
            body(x0)
            kernels[name] = {k: v for k, v in fk.launches.items() if v}
            results[name] = _timed_loop(body, x0, dev)

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
