#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (dhg_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json]

Phases, each fatal on failure (nonzero exit, no result line):
  1. card      — device name; nvidia-smi name and power limit
  2. build     — nvcc builds dhg_torch/kernels/csrc/*.cu for sm_90a (timed)
  3. kernels   — each CUDA kernel against its plain PyTorch version on the
                 card, at the shapes its path gives it. Sampler kernels
                 (canonical model, seq_len 392, 50 text tokens): bottleneck at
                 batch 1 and 96, enc3 and enc5 at batch 96; bar rtol = atol =
                 0.05 and median |diff| < 5e-3 (bf16). Train-path kernels
                 (T = 480, L = 50, batch 96): fused_attention at its 7 shapes
                 in bf16 at that bar; fused_conv_block at its 6 shapes in
                 bf16 at that bar and in f32 at rtol = atol = 1e-4 (f32 FMAs
                 in another sum order); beside each, SDPA's time for
                 attention. Then each autograd.Function's backward against
                 the plain backward. Times from CUDA events.
  4. denoise   — one full-width bf16 denoise with the kernels against the
                 port's plain module path (kernels off), same bar
  5. generate  — the sampler: sample_lines -> generate, full width, bf16,
                 60 steps, mode "new", seq_len 392, at batch 96 and batch 1.
                 Launch counts zeroed just before each run and read just
                 after: 60 bottleneck + 120 encoder-layer launches at batch 96,
                 60 + 0 at batch 1; output finite, [B, 392, 3]
  6. timings   — denoise steps/s at batch 256 and p50 line latency at batch 1
  7. train     — the training path: dhg_torch.train.main from a config dict
                 (tools/profile_train.py::best_config, configs/best.yml's model
                 and batch: channels 128, 2 layers, batch 96, T 480, bf16;
                 synthetic data) for 20 steps with
                 DHG_FUSED_ATTENTION=1 and DHG_FUSED_CONVBLOCK=1. Counts
                 zeroed just before and read just after: 9 attention and 6
                 conv-block launches a step, none of the sampler kernels;
                 losses finite; checkpoint_20 and model_final written;
                 model_final reloads and samples one 60-step batch of 4
  8. train rate — train_steps_per_sec_batch96 with both kernels and with
                 both flags off, in turns (off, on, on, off): CUDA events
                 over 10 steps after one warm-up step
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
import tempfile
import time

import numpy as np
import torch

SEQ_LEN = 392  # infer_seq_len(24): a 23-character prompt + EOS
TEXT_LEN = 50  # sample_lines' max_text_len
N_STEPS = 60
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # CUDA-core float32 peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
SOURCES = {
    "fused_bottleneck": "dhg_torch/kernels/csrc/encoder_layer.cu",
    "fused_encoder_layer": "dhg_torch/kernels/csrc/encoder_layer.cu",
    "fused_attention": "dhg_torch/kernels/csrc/attention.cu",
    "fused_conv_block": "dhg_torch/kernels/csrc/conv_block.cu",
}
REPLACES = {
    "fused_bottleneck": "dhg/kernels/fused_bottleneck.py:476",
    "fused_encoder_layer": "dhg/kernels/fused_bottleneck.py:242",
    "fused_attention": "dhg/kernels/fused_attention.py:60",
    "fused_conv_block": "dhg/kernels/fused_conv_block.py:76",
}
TRAIN_B, TRAIN_STEPS = 96, 20  # T = 480 (tools/profile_train.py::best_config)
# The training forward's attention calls at T = 480, L = 50: (label, H, Tq,
# Tk, D, masked, launches a step).
TRAIN_ATTENTION = [("text-style cross", 8, TEXT_LEN, 70, 48, False, 1),
                   ("enc3 cross", 3, 240, TEXT_LEN, 64, True, 1),
                   ("enc3 self", 3, 240, 240, 64, False, 1),
                   ("enc5 cross", 4, 120, TEXT_LEN, 64, True, 1),
                   ("enc5 self", 4, 120, 120, 64, False, 1),
                   ("att cross", 6, 60, TEXT_LEN, 64, True, 2),
                   ("att self", 6, 60, 60, 64, False, 2)]
# Its ConvBlocks: (label, T, Cin, Co).
TRAIN_CONV = [("enc1", 480, 128, 128), ("enc2", 240, 128, 192), ("enc4", 120, 192, 256),
              ("dec3", 120, 384, 256), ("dec2", 240, 256, 192), ("dec1", 480, 192, 128)]


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


def compare(name, got, ref, tol=0.05, median_bar=5e-3):
    """max |diff|; fails unless |diff| <= tol (1 + |ref|) everywhere and
    the median |diff| < median_bar."""
    a, b = got.float(), ref.float()
    diff = (a - b).abs()
    max_err, med = float(diff.max()), float(diff.median())
    ok = bool(torch.all(diff <= tol + tol * b.abs())) and med < median_bar
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


def roofline(flops, bytes_, peak):
    """(bound_ms, bound_by): the larger of flops over `peak` and bytes over HBM."""
    t_ops, t_bytes = flops / peak, bytes_ / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def timed_case(kname, label, run, plain, bound_, library=None, tol=0.05, median_bar=5e-3):
    got = run()
    torch.cuda.synchronize()
    err = compare(label, got, plain(), tol, median_bar)
    ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 5)
    lib_ms = cuda_ms(library, 20) if library is not None else None
    b_ms, b_by = bound_
    log(f"    kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
        f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} | bound {b_ms:.5f} ms ({b_by})")
    return dict(kernel=kname, case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def train_kernel_phase(report):
    """fused_attention and fused_conv_block at every training-path shape."""
    import torch.nn.functional as F

    from dhg_torch.kernels import fused_attention as fa
    from dhg_torch.kernels import fused_conv_block as fc

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf, b = torch.bfloat16, TRAIN_B
    rows = []
    lengths = torch.randint(12, TEXT_LEN, (b,), generator=gen, device="cuda")
    for label, h, tq, tk, d, masked, per_step in TRAIN_ATTENTION:
        q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda").to(bf) for n in (tq, tk, tk))
        mask = keep = None
        if masked:
            mask = (torch.arange(tk, device="cuda")[None] > lengths[:, None]).float()[:, None, None]
            keep = mask == 0
        flops = 4 * b * h * tq * tk * d
        bytes_ = 2 * b * h * (2 * tq * d + 2 * tk * d) + (4 * b * tk if masked else 0)
        row = timed_case(
            "fused_attention", f"attention {label} B={b}",
            lambda: fa.fused_attention(q, k, v, mask), lambda: fa.attention_plain(q, k, v, mask),
            roofline(flops, bytes_, H100_BF16_FLOPS),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
        )
        rows.append(dict(row, per_step=per_step, shape=[b, h, tq, tk, d], masked=masked))
    for label, t, cin, co in TRAIN_CONV:
        c2 = co // 2

        def r(*shape, scale=1.0, base=0.0):
            return base + scale * torch.randn(*shape, generator=gen, device="cuda")

        ops = [r(3, cin, co, scale=(3 * cin) ** -0.5), r(co, scale=0.1),
               r(3, cin, c2, scale=(3 * cin) ** -0.5), r(c2, scale=0.1),
               r(3, c2, co, scale=(3 * c2) ** -0.5), r(co, scale=0.1),
               r(co, co, scale=co ** -0.5), r(co, scale=0.1)]
        for c in (c2, co, co):  # FiLM gamma, beta per row
            ops += [r(b, c, scale=0.1, base=1.0), r(b, c, scale=0.1)]
        x32 = r(b, t, cin)
        flops = 2 * b * t * (3 * cin * co + 3 * cin * c2 + 3 * c2 * co + co * co)
        w_bytes = 4 * (sum(o.numel() for o in ops))
        for dt, elem, tol, med in ((bf, 2, 0.05, 5e-3), (torch.float32, 4, 1e-4, 1e-4)):
            x = x32.to(dt)
            row = timed_case(
                "fused_conv_block", f"conv block {label} {str(dt)[6:]} B={b}",
                lambda: fc.fused_conv_block(x, *ops), lambda: fc.conv_block_plain(x, *ops),
                roofline(flops, w_bytes + elem * b * t * (cin + co), H100_F32_FLOPS),
                tol=tol, median_bar=med,
            )
            rows.append(dict(row, per_step=1 if dt == bf else 0, shape=[b, t, cin, co]))
    report["train_kernel_cases"] = rows
    return rows


def gradient_phase(report):
    """Each autograd.Function's backward against autograd through the plain
    version, at one training-path shape each."""
    from dhg_torch.kernels.fused_attention import FusedAttention
    from dhg_torch.kernels.fused_conv_block import ConvBlockFn, conv_block_plain
    from dhg_torch.ops.attention import sdpa_math

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, bf = TRAIN_B, torch.bfloat16
    q, k, v = (torch.randn(b, 4, n, 64, generator=gen, device="cuda").to(bf) for n in (120, 50, 50))
    mask = (torch.rand(b, 1, 1, 50, generator=gen, device="cuda") > 0.8).float()
    mask[..., 0] = 0.0
    cases = {"FusedAttention (enc5 cross)": (FusedAttention.apply, sdpa_math, [q, k, v], [mask])}
    x = torch.randn(b, 120, 192, generator=gen, device="cuda").to(bf)
    ops = [0.05 * torch.randn(*s, generator=gen, device="cuda")
           for s in ((3, 192, 256), (256,), (3, 192, 128), (128,), (3, 128, 256), (256,),
                     (256, 256), (256,), (b, 128), (b, 128), (b, 256), (b, 256), (b, 256), (b, 256))]
    cases["ConvBlockFn (enc4)"] = (ConvBlockFn.apply, conv_block_plain, [x, *ops], [])
    out = {}
    for name, (fn, plain, leaves, rest) in cases.items():
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        y = fn(*leaves, *rest)
        g = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
        got = torch.autograd.grad(y, leaves, g)
        want = torch.autograd.grad(plain(*leaves, *rest), leaves, g)
        err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
        scale = max(float(w.float().abs().max()) for w in want)
        log(f"  {name}: max |grad diff| {err:.3g} (largest grad {scale:.3g})")
        if err > 1e-5 * scale:
            fail(f"{name}: backward disagrees with the plain backward")
        out[name] = err
    report["grad_max_abs_err"] = out


def set_train_flags(on: bool) -> None:
    from dhg_torch.tools.profile_train import FLAGS

    for name in FLAGS:
        os.environ[name] = "1" if on else "0"


def reset_all_counts() -> None:
    from dhg_torch.kernels import fused_attention as fa
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels import fused_conv_block as fc

    fk.reset_launch_counts()
    fa.reset_launch_count()
    fc.reset_launch_count()


def train_phase(report):
    from dhg_torch.config import DLConfig
    from dhg_torch.inference import sample_lines
    from dhg_torch.kernels import fused_attention as fa
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels import fused_conv_block as fc
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools.profile_train import best_config
    from dhg_torch.train import main as train_main

    set_train_flags(True)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        t0 = time.perf_counter()
        trainer = train_main(DLConfig(best_config(tmp, TRAIN_STEPS, TRAIN_B)), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (fa.launches["fused_attention"], fc.launches["fused_conv_block"],
               fk.launches["fused_bottleneck"] + fk.launches["fused_encoder_layer"])
        want = (9 * TRAIN_STEPS, 6 * TRAIN_STEPS, 0)
        log(f"  {TRAIN_STEPS} steps in {wall:.1f} s (run set-up and saves included); launches "
            f"attention {got[0]}, conv block {got[1]}, sampler kernels {got[2]} (want {want})")
        if got != want:
            fail(f"train: launches {got}, expected {want}")
        run = trainer.exp_dir
        rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in rows]
        log(f"  logged steps {[r['step'] for r in rows]}, losses {losses}")
        if [r["step"] for r in rows] != [5, 10, 15, 20] or not np.all(np.isfinite(losses)):
            fail("train: bad metrics.jsonl")
        saved = torch.load(run / "checkpoint_20", map_location="cpu", weights_only=True)
        if saved.get("step") != 20 or not (run / "model_final").is_file():
            fail("train: checkpoint_20 / model_final missing")
        raw = DiffusionModel.load(run / "model_final", use_ema=False, device="cuda")
        same = all(torch.equal(a, b) for a, b in zip(raw.state_dict().values(),
                                                     trainer.model.state_dict().values()))
        if not same:
            fail("train: model_final does not hold the trained weights")
        model = DiffusionModel.load(run / "model_final", dtype=torch.bfloat16, device="cuda")
        prompts, _, style = make_inputs(4, seed=21)
        lines = sample_lines(model, prompts, style, torch.Generator(device="cuda").manual_seed(4),
                             device="cuda")
        ok = len(lines) == 4 and all(a.shape == (SEQ_LEN, 3) and np.isfinite(a).all() for a in lines)
        log(f"  model_final reloaded; 60-step sample_lines at batch 4: "
            f"{'finite' if ok else 'BAD'}, shapes {sorted({a.shape for a in lines})}")
        if not ok:
            fail("train: sampling from model_final failed")
    set_train_flags(False)
    report.update(train_wall_s=wall, train_losses=losses,
                  train_peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                  train_launches={"fused_attention": got[0], "fused_conv_block": got[1]})
    return got


def train_rate_phase(report):
    from dhg_torch.config import DLConfig
    from dhg_torch.tools.profile_train import best_config
    from dhg_torch.train import Trainer

    rates = {"kernels": [], "plain": []}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = DLConfig(best_config(tmp, 0, TRAIN_B))
        for label in ("plain", "kernels", "kernels", "plain"):
            set_train_flags(label == "kernels")
            trainer = Trainer(cfg, device="cuda")
            trainer.train_step(trainer.draw(1))
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for c in range(2, 12):
                trainer.train_step(trainer.draw(c))
            end.record()
            end.synchronize()
            rates[label].append(10 / (start.elapsed_time(end) / 1e3))
            del trainer
            torch.cuda.empty_cache()
    set_train_flags(False)
    for label, r in rates.items():
        log(f"  {label}: train steps/s at batch 96: {', '.join(f'{v:.3f}' for v in r)}")
    report["train_steps_per_sec_batch96"] = {k: statistics.mean(v) for k, v in rates.items()}
    report["train_steps_per_sec_batch96_runs"] = rates


def kernel_row(name, cases, timed, launches, at):
    """One kernels-line entry: max |diff| over all of the kernel's cases;
    times and bounds summed over `timed` (weighted by launches a step)."""
    lib = [r.get("library_ms") for r in timed]

    def total(key):
        return sum(r[key] * r.get("per_step", 1) for r in timed)

    return {
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cases if r["kernel"] == name),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": max(timed, key=lambda r: r["bound_ms"] * r.get("per_step", 1))["bound_by"],
        # None where no single PyTorch call computes the function (an encoder
        # layer; a ConvBlock is 3 convs, a Dense and 3 FiLMs).
        "library_ms": None if None in lib else total("library_ms"),
        "at": at,
    }


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
        log("== train-path kernels against their plain versions (T 480, batch 96)")
        cases += train_kernel_phase(report)
        log("== denoise with kernels against the plain module path")
        denoise_phase(model, report)
    log("== backward of the autograd.Functions against the plain backward")
    gradient_phase(report)
    log("== sampler: sample_lines -> generate")
    counts = generate_phase(model, report)
    log("== timings")
    timing_phase(model, report)
    del model
    torch.cuda.empty_cache()
    log("== train: dhg_torch.train.main, batch 96, both train-path kernels")
    train_counts = train_phase(report)
    log("== train rate: kernels against the plain-op path")
    train_rate_phase(report)

    def timed(name, keep):
        return [r for r in cases if r["kernel"] == name and keep(r)]

    kernels = [
        kernel_row("fused_bottleneck", cases,
                   timed("fused_bottleneck", lambda r: r["case"].endswith("B=96")),
                   counts[96][0], "bottleneck B=96"),
        kernel_row("fused_encoder_layer", cases,
                   timed("fused_encoder_layer", lambda r: r["case"].startswith("enc3")),
                   counts[96][1], "enc3 B=96"),
        kernel_row("fused_attention", cases, timed("fused_attention", lambda r: True),
                   train_counts[0], "sum over one training forward's 9 calls, B=96, T=480"),
        kernel_row("fused_conv_block", cases, timed("fused_conv_block", lambda r: r["per_step"]),
                   train_counts[1], "sum over one training forward's 6 blocks, bf16, B=96, T=480"),
    ]
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
