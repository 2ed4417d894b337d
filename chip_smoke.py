#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (dhg_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json]

Phases, each fatal on failure (nonzero exit, no result line):
  1. card      — device name; nvidia-smi name and power limit
  2. build     — nvcc builds dhg_torch/kernels/csrc/*.cu for sm_90a (timed)
  3. kernels   — each CUDA kernel against its plain PyTorch version on the
                 card, at the shapes the main path gives it (canonical model,
                 seq_len 392, 50 text tokens): bottleneck at batch 1 and 96,
                 enc3 and enc5 at batch 96. Bar: rtol = atol = 0.05 and
                 median |diff| < 5e-3. Kernel and plain times from CUDA events.
  4. denoise   — one full-width bf16 denoise with the kernels against the
                 port's plain module path (kernels off), same bar
  5. generate  — the main path: sample_lines -> generate, full width, bf16,
                 60 steps, mode "new", seq_len 392, at batch 96 and batch 1.
                 Launch counts zeroed just before each run and read just
                 after: 60 bottleneck + 120 encoder-layer launches at batch 96,
                 60 + 0 at batch 1; output finite, [B, 392, 3]
  6. timings   — denoise steps/s at batch 256 and p50 line latency at batch 1
The weights are random (seed 0); depth is the canonical 2 attention layers.

Stdout ends with the kernels line, the nvidia-smi line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEQ_LEN = 392  # infer_seq_len(24): a 23-character prompt + EOS
TEXT_LEN = 50  # sample_lines' max_text_len
N_STEPS = 60
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
SOURCE = "dhg_torch/kernels/csrc/encoder_layer.cu"
REPLACES = {
    "fused_bottleneck": "dhg/kernels/fused_bottleneck.py:476",
    "fused_encoder_layer": "dhg/kernels/fused_bottleneck.py:242",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def layer_work(b, t, d, l):
    """(FLOPs, weight bytes) of one EncoderLayer.attend on b rows: every
    matrix product counted as 2 m n k; bf16 weights, biases and FiLM."""
    per_row = 2 * t * d * d * 6 + 2 * t * d * 2 * d * 2  # wq wo wq2 wk2 wv2 wo2, fc1 fc2
    per_row += 2 * t * l * d * 2 + 2 * t * t * d * 2  # cross and self attention
    weight_bytes = 2 * (10 * d * d + 9 * d + 6 * d)
    return b * per_row, weight_bytes


def bound(b, t, d, h, l, cin=None, n_layers=1):
    """(bound_ms, bound_by, GFLOP, MB): the larger of FLOPs over the bf16 peak
    and bytes (inputs read once, output written once) over HBM bandwidth."""
    flops, w_bytes = layer_work(b, t, d, l)
    flops *= n_layers
    bytes_ = n_layers * (w_bytes + 2 * 2 * b * l * d)  # weights, kh + vh
    bytes_ += 2 * (b * t * (cin or d) + t * d + b * l + b * t * d)  # x, pe, neg, out
    if cin is not None:
        flops += 2 * b * t * cin * d
        bytes_ += 2 * (cin * d + d)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, bytes_ / H100_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops / 1e9, bytes_ / 1e6


def compare(name, got, ref):
    a, b = got.float(), ref.float()
    diff = (a - b).abs()
    max_err, med = float(diff.max()), float(diff.median())
    ok = bool(torch.all(diff <= 0.05 + 0.05 * b.abs())) and med < 5e-3
    ok = ok and bool(torch.isfinite(a).all())
    log(f"  {name}: max|diff| {max_err:.5f}  median|diff| {med:.6f}  -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


def make_inputs(batch, seed):
    """Token ids ([B, 50], a 23-character prompt + EOS, zero-padded) and
    style features [B, 14, 1280], made from `seed` with numpy."""
    from dhg_torch.data.tokenizer import Tokenizer

    rng = np.random.RandomState(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz ")
    prompts = ["".join(rng.choice(alphabet, 23)) for _ in range(batch)]
    text = torch.from_numpy(Tokenizer().encode_batch(prompts, TEXT_LEN)).cuda()
    style = torch.from_numpy(rng.randn(batch, 14, 1280).astype(np.float32)).cuda()
    return prompts, text, style


def level_context(model, text, style, level=30):
    """The sampler's hoisted context at one noise level: (kvs, films, mask)."""
    from dhg_torch.core.schedule import get_alpha_set
    from dhg_torch.ops.basic import create_padding_mask

    sig = torch.sqrt(get_alpha_set()[level]).reshape(1, 1).cuda()
    se = model.embed_sigma(sig)
    cond = model.encode_cond(text, style, se)
    return model.precompute_cross_kv(cond, se), model.precompute_film(se), create_padding_mask(text)


def kernel_phase(model, report):
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.models.denoiser import encoder_layer_operands

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for batch in (96, 1):
        _, text, style = make_inputs(batch, seed=batch)
        kvs, films, mask = level_context(model, text, style)
        t8 = SEQ_LEN // 8
        x8 = torch.randn(batch, t8, model.c3, generator=gen, device="cuda").to(bf)
        ops = model.bottleneck_operands(x8, kvs, films, mask)
        nl, heads = model.num_layers, model.att_layers[0].num_heads
        cases = [("fused_bottleneck", f"bottleneck B={batch}",
                  lambda o=ops: fk.fused_bottleneck(*o, nl, heads),
                  lambda o=ops: fk.bottleneck_plain(*o, nl, heads),
                  bound(batch, t8, model.c2 * 2, heads, TEXT_LEN, cin=model.c3, n_layers=nl))]
        if batch == 96:
            for name, layer, t, idx in (("enc3", model.enc3, SEQ_LEN // 2, 0),
                                        ("enc5", model.enc5, SEQ_LEN // 4, 1)):
                x = torch.randn(batch, t, layer.d_out, generator=gen, device="cuda").to(bf)
                lo = encoder_layer_operands(layer, x, kvs[idx], films["attn"][idx], mask)
                cases.append(("fused_encoder_layer", f"{name} B={batch}",
                              lambda o=lo, h=layer.num_heads: fk.fused_encoder_layer(*o, h),
                              lambda o=lo, h=layer.num_heads: fk.encoder_layer_plain(*o, h),
                              bound(batch, t, layer.d_out, layer.num_heads, TEXT_LEN)))
        for kname, label, run, plain, (b_ms, b_by, gflop, mb) in cases:
            got = run()
            torch.cuda.synchronize()
            err = compare(label, got, plain())
            ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
            log(f"    kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound {b_ms:.5f} ms "
                f"({b_by}; {gflop:.3f} GFLOP, {mb:.3f} MB)")
            rows.append(dict(kernel=kname, case=label, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             gflop=gflop, mbytes=mb))
    report["kernel_cases"] = rows
    return rows


def denoise_phase(model, report):
    """Full-width bf16 denoise with the kernels == the plain module path."""
    from dhg_torch.kernels import fused_bottleneck as fk

    _, text, style = make_inputs(96, seed=3)
    kvs, films, mask = level_context(model, text, style, level=10)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(96, SEQ_LEN, 2, generator=gen, device="cuda")
    before = dict(fk.launches)
    eps_k, pen_k = model.denoise(x, None, None, mask, kvs=kvs, films=films)
    torch.cuda.synchronize()
    if fk.launches["fused_bottleneck"] != before["fused_bottleneck"] + 1:
        fail("denoise did not take the bottleneck kernel")
    os.environ["DHG_FUSED_BOTTLENECK"] = "0"
    try:
        eps_p, pen_p = model.denoise(x, None, None, mask, kvs=kvs, films=films)
    finally:
        del os.environ["DHG_FUSED_BOTTLENECK"]
    report["denoise_eps_max_abs_err"] = compare("denoise eps (kernels vs plain)", eps_k, eps_p)
    report["denoise_pen_max_abs_err"] = compare("denoise pen (kernels vs plain)", pen_k, pen_p)


def generate_phase(model, report):
    from dhg_torch.inference import sample_lines
    from dhg_torch.kernels import fused_bottleneck as fk

    counts = {}
    for batch, want in ((96, (60, 120)), (1, (60, 0))):
        prompts, _, style = make_inputs(batch, seed=10 + batch)
        gen = torch.Generator(device="cuda").manual_seed(batch)
        fk.reset_launch_counts()
        lines = sample_lines(model, prompts, style, gen, diffusion_mode="new", device="cuda")
        got = (fk.launches["fused_bottleneck"], fk.launches["fused_encoder_layer"])
        counts[batch] = got
        shapes = {a.shape for a in lines}
        finite = all(np.isfinite(a).all() for a in lines)
        log(f"  generate B={batch}: launches bottleneck {got[0]}, encoder layer {got[1]}; "
            f"shapes {sorted(shapes)}; finite {finite}")
        if got != want:
            fail(f"generate B={batch}: launches {got}, expected {want}")
        if shapes != {(SEQ_LEN, 3)} or len(lines) != batch or not finite:
            fail(f"generate B={batch}: bad output")
    report["launches"] = {str(k): v for k, v in counts.items()}
    return counts


def timing_phase(model, report):
    from dhg_torch.inference import generate

    def run(batch, seed):
        _, text, style = make_inputs(batch, seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return lambda: generate(model, text, style, gen, seq_len=SEQ_LEN, device="cuda")

    big = run(256, 5)
    ms256 = cuda_ms(big, iters=2, warmup=1)
    steps_per_s = 256 * N_STEPS / (ms256 / 1e3)
    one = run(1, 6)
    one()
    lat = []
    for _ in range(7):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        one()
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end) / 1e3)
    p50 = statistics.median(lat)
    log(f"  batch 256: {ms256:.1f} ms per 60-step call -> {steps_per_s:.1f} denoise steps/s")
    log(f"  batch 1: p50 line latency {p50 * 1e3:.2f} ms (7 calls: "
        f"{', '.join(f'{v * 1e3:.1f}' for v in lat)})")
    report.update(denoise_steps_per_sec_b256=steps_per_s, ms_per_call_b256=ms256,
                  p50_line_latency_s_b1=p50, line_latencies_s_b1=lat)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from dhg_torch.kernels import build
        from dhg_torch.models.denoiser import DiffusionModel
    except ImportError as e:
        fail(f"the dhg_torch package is not importable here ({e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}

    log("== card")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    log(f"  {kind} ({count} visible); nvidia-smi: {smi_line or 'unavailable'}")
    report.update(device=kind, nvidia_smi=smi_line, torch=torch.__version__, cuda=torch.version.cuda)

    log("== build")
    t0 = time.perf_counter()
    try:
        lib_path = build.build()
        build.load()
    except (RuntimeError, OSError) as e:
        fail(f"kernel build failed: {e}")
    report["build_s"] = time.perf_counter() - t0
    log(f"  {lib_path.name} in {report['build_s']:.1f} s")

    model = DiffusionModel.from_config({"channels": 128, "att_layers_num": 2},
                                       dtype=torch.bfloat16, device="cuda", seed=0)
    with torch.inference_mode():
        log("== kernels against their plain versions (main-path shapes)")
        cases = kernel_phase(model, report)
        log("== denoise with kernels against the plain module path")
        denoise_phase(model, report)
    log("== main path: sample_lines -> generate")
    counts = generate_phase(model, report)
    log("== timings")
    timing_phase(model, report)

    kernels = []
    for name in ("fused_bottleneck", "fused_encoder_layer"):
        rows = [r for r in cases if r["kernel"] == name]
        main = next(r for r in rows if r["case"].endswith("B=96"))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": counts[96][0 if name == "fused_bottleneck" else 1],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes an encoder layer
            "at": main["case"],
        })
    report["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
