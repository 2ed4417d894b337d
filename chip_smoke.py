#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (dhg_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json]

Phases, each fatal on failure (nonzero exit, no result line):
  1. card      — device name; nvidia-smi name and power limit
  2. build     — nvcc builds dhg_torch/kernels/csrc/*.cu for sm_90a (timed)
                 on a background thread while phase 7c (serve, which runs no
                 kernel) runs on a plain run of the train cell; the kernel
                 phases start once both are done
  3. kernels   — each CUDA kernel against its plain PyTorch version on the
                 card, at the shapes its path gives it. Sampler kernels
                 (canonical model, seq_len 392, 50 text tokens): bottleneck at
                 batch 96, 1 and 256 (logged with its cluster size and how
                 many clusters the card holds at once) and, at the 808 steps
                 of a 50-token prompt (T8 = 101, a spilled row), at batch 96
                 and 1; enc3 and enc5 (fused_encoder_layer, logged with
                 its cluster of CTAs split by sequence rows) at batch 96, 1,
                 8 and 256, and at the 808 steps of a 50-token prompt (T =
                 404 / 202) at batch 96; bar rtol = atol = 0.05 and
                 median |diff| < 5e-3 (bf16). Train-path kernels (T = 480,
                 L = 50, batch 96): fused_attention at its 7 shapes in bf16
                 at that bar; fused_conv_block at its 6 shapes in bf16 at that bar
                 and in f32 at rtol = atol = 1e-4 (3xTF32 tensor-core
                 products, sums in another order), each logged with its tile,
                 ring slots and CTAs resident, then at ragged T (1, 2, 17 and
                 the 62-row tile - 1 and + 1) in both types, and in f32 at
                 dec3's widths against conv_block_plain in float64 (within
                 1e-5 of the output's scale); beside each attention case,
                 SDPA's time. Then each autograd.Function's backward against
                 the plain backward. Times from CUDA events.
  4. denoise   — one full-width bf16 denoise with the kernels against the
                 port's plain module path (kernels off), same bar
  4b. T4       — fused_unet_t4 against unet_t4_plain at batch 96, 1, 8
                 and 256 (operands from the canonical model's t4_operands,
                 [B, 98, 192] -> [B, 98, 256]) and at a 50-token prompt's
                 T4 = 202 at batch 96, same bar, CUDA events over 20
                 launches beside the bound, each logged with its cluster of
                 CTAs and the clusters resident; then one full-width bf16
                 denoise with DHG_FUSED_T4=1 (one T4 launch, no other
                 sampler kernel) against the plain module path, same bar;
                 then the kernel's yardstick at batch 1, 96 and 256: the
                 default path over the same region (DiffusionModel.
                 t4_region) beside the kernel, and one whole denoise step
                 with the flag off and on
  5. generate  — the sampler: sample_lines -> generate, full width, bf16,
                 60 steps, mode "new", seq_len 392, at batch 96 and batch 1,
                 then a batch of 8 padded to one 49-character prompt
                 (seq_len 808, T8 = 101: the bottleneck's spilled rows).
                 Launch counts zeroed just before each run and read just
                 after: 60 bottleneck + 120 encoder-layer launches at batch 96
                 and 8, 60 + 0 at batch 1, no T4 launch; output finite, each
                 line [16 tokens + 8, 3]. Then the same with DHG_FUSED_T4=1:
                 60 fused_unet_t4 launches and none of the other two, at
                 batch 96 and 1
  5c. sampler graphs — on a model of its own (every key unseen): generate
                 three times on one key (the eager call, the capture, a
                 replay) at batch 1, 96 and 256 (seq_len 392), 8 padded to
                 seq_len 808 (the spilled bottleneck), 1 and 96 with
                 DHG_FUSED_T4=1, and at batch 8 guided (1.5, 1.5, then 3.0:
                 one graph), hoist "full", encoder_reuse=2, sample_seeds and
                 DDIM on the halved 30-step schedule. The third call equals
                 `_sample` on the same generator seed bit for bit
                 (torch.equal) and leaves the generator in the same state;
                 its launches equal the eager call's (60 bottleneck + 120
                 encoder-layer at 96, 60 T4 and no other with the flag); one
                 capture a key; each call's host ms, the capture's seconds,
                 its peak memory and the pool's size logged. Then
                 DHG_FUSED_T4 off, on, off at batch 96 (each call equal to
                 its own path's eager call, no capture), and a weight
                 changed in place after the capture (the replay reads it)
                 and one whose storage is replaced (captured again)
  5b. launches — profile_sampler.py's 10-step generate at batch 1, 96 and
                 256, DHG_FUSED_T4 off and on, replayed and eager
                 (`_sample`): launches, device time, idle share
  6. timings   — denoise steps/s at batch 256 and at batch 96 (where both
                 sampler kernels run) and p50 line latency at batch 1, with
                 DHG_FUSED_T4 off and on in the order off, on, on, off at
                 each batch, every call reported: generate replayed (two
                 warm-up calls a key), then the eager `_sample`
  7. train     — the training path: dhg_torch.train.main from a config dict
                 (tools/profile_train.py::best_config, configs/best.yml's model
                 and batch: channels 128, 2 layers, batch 96, T 480, bf16;
                 synthetic data) for 20 steps with
                 DHG_FUSED_ATTENTION=1 and DHG_FUSED_CONVBLOCK=1. Counts
                 zeroed just before and read just after: 9 attention and 6
                 conv-block launches a step, none of the sampler kernels;
                 losses finite; checkpoint_20 and model_final written;
                 model_final reloads and samples one 60-step batch of 4
  7b. infer    — dhg_torch.inference.main on that run dir (f32, as dhg's
                 infer): a style PNG written with the port's own writer,
                 data/style_trunk_synth.npz, a 23-character prompt to a PNG
                 (decoded again through dhg_torch.data.images), then
                 --wrap=12 to an SVG; strokes finite, no kernel launched
  7c. serve    — dhg_torch.serve (run first, beside the build) on the run
                 dir of a 20-step plain run of phase 7's train cell (both
                 train flags off; f32, as dhg's serve; no kernel launched):
                 GenerationService.from_experiment with a bank of two style
                 PNGs, warm-up of dhg's default grid
                 (buckets 200 and 400, modes new and standard, max_batch 16:
                 20 captured CUDA graphs; seconds and peak memory logged); a
                 replay at batch 1 and 16 bit-identical to the eager
                 generate on the same draws, both timed and profiled (idle
                 share); five solo requests (client latency beside the
                 service's own ms); tools/bench_serve.py's run_level with
                 the 23-character prompt at 1 client x 100, 16 x 16 and 64 x 8
                 requests, so that every level's p99 rests on 100 or more
                 latencies (lines/s, p50/p99, the batches' sizes and, from
                 the service's batch_log, when each batch's requests arrived
                 against when the batcher took the batch; the capture count
                 must not move); a page
                 request; the host time of the noise streams at batch 16 and
                 256; then `python -m dhg_torch.serve` as a subprocess: a
                 request, SIGTERM, exit 0 after "stopped (drained)"
  7d. iam      — the IAM data path: dhg_torch.tools.gen_iam_scale writes a
                 tree of 192 train and 48 validation forms (seed 7); both
                 caches built on the card (style vectors from the StyleExtractor
                 with data/style_trunk_synth.npz, as phase 7b) through load_or_build_cache (the
                 native stroke scanner must parse every file; lines kept and
                 dropped by filter, seconds by stage, lines/s, peak memory),
                 then loaded again without a rebuild; 20 steps of
                 dhg_torch.train.main with dataset iam (configs/best.yml's
                 model and batch, both train-path kernels: 9 and 6 launches
                 a forward, the steps' and the val_freq passes' at steps 10
                 and 20; the passes through one make_eval_fn step that
                 captured one graph a batch shape), checkpoints 10 and 20
                 averaged (tools/average_checkpoints) and loaded; the eval
                 CLI on the soup (one finite Val Loss line, one capture a
                 batch shape); the metrics CLI (64
                 samples, batch 32, the f32 60-step sampler at seq_len 480:
                 finite KS distances and frechet_style_distance)
  7e. distill  — dhg_torch.distill.main (f32, as dhg's CLI) from the train
                 run's model_final, 60 -> 30, 20 steps at batch 96, flags
                 off then on, on the same draws, each step after the first
                 a replay of the captured step graph: launches zeroed before
                 each CLI run and read after (with the flags on 27
                 attention and 18 conv-block launches a step, 9 and 6 for
                 each of the closing probe's 90 sampler levels; none off);
                 the first step's loss triples within 1e-4 relative; steps/s
                 from CUDA events (steps 2-20, replayed); the infer CLI on
                 the student with no
                 flags must take 30 steps, the halved grid and DDIM;
                 tools/probe_distill --multi=1 (f32) finite; then the
                 probe's three generate calls on teacher and student loaded
                 in bf16 at B = 8: 120 bottleneck and 240 encoder-layer
                 launches, finite
  7f. multiprocess — `python -m dhg_torch.train` (f32, batch 96, both
                 train flags, 5 steps, a validation after step 4; two runs
                 at a time on the card, the first two, then the gloo two): in an
                 NCCL group of one process, equal bit for bit to the run
                 without a group (losses and the replayed validation); two
                 processes sharing the card under gloo at data_parallel 2,
                 then model_parallel 2 (each run.log shows its mesh, that
                 steps_per_call auto is 1 under gloo and that validation
                 runs eagerly under gloo), losses
                 within 1e-4 relative of the run without a group, one run
                 dir; the model_parallel run's model_final loads strictly
                 into a one-device model
  7g. opt-in samplers and tools — the canonical model, random weights
                 (seed 0), bf16, seq_len 392: generate(hoist="full")
                 against the compact hoist on the same draws at batch 96
                 and 256 (bit for bit, else within 1e-3 stroke MSE), launch
                 counts 60 bottleneck + 120 encoder-layer at 96 (60 + 0 at
                 256; with DHG_FUSED_T4=1, 60 T4 and no other), peak memory
                 and ms of both (compact, full, full, compact); encoder
                 reuse at batch 96: k = 1 equal to the compact sampler (and
                 the reuse sampler itself at reuse_every 1 bit for bit or
                 within 1e-3), k = 2 and 3 with 60 bottleneck and
                 2 ceil(60 / k) encoder-layer launches (no T4 launch with
                 the flag: dhg fuses T4 in denoise only), stroke MSE
                 against k = 1, ms of each k; Jacobi DDIM at batch 1 in f32:
                 60 sweeps within 1e-3 stroke MSE of the sequential DDIM on
                 the same x_T, no sampler-kernel launch (the full forward's
                 per-row sigma closes their gate), peak memory, then
                 tools/eval_parallel_sampler.py at its defaults in bf16 (0
                 launches asserted); a 4-step train CLI run (the training
                 cell, both train flags) with profile_start 2 and
                 profile_steps 1: one Chrome trace holding steps 2-3 that
                 names attention_mma_kernel and conv_block_kernel; then
                 eval_fewer_steps and eval_encoder_reuse on the train run
                 (f32), sweep (batch 96), bench_hoist and profile_stages (batch 96:
                 each stage's kernels) at small arguments, each report's
                 JSON parsed and its keys checked, and plot_run's PNG of
                 the profile run
  7h. style trunk — flax's random MobileNetV2 init (the default trunk,
                 data/mobilenetv2_tv.npz being absent): its feature std on
                 eval_style_gap's 8 x 6 benchmark lines (fatal below 1e-4; a
                 torch-default init gave ~1e-8); tools/train_style_trunk.py at
                 dhg's defaults (600 steps, 128 writers x 16 lines, batch 64,
                 width 384; steps/s), then `evaluate` of the trained and the
                 random trunk on the 8 x 6 benchmark; tree mode on phase 7d's
                 tree (32 forms, 100 steps, held-out retrieval); the
                 eval_style_gap CLI (8 x 6, the style ablation on phase 7d's
                 run): the trained trunk's retrieval must beat its
                 pixel_baseline; eval_fsd_sensitivity on phase 7d's train
                 cache (n = min(48, rows // 2), the random and the trained
                 trunk); eval_style_pathway on phase 7d's run (both probes);
                 each report's keys dhg's plus "backend"; none of the five
                 kernels launched (counts zeroed before the phase, read
                 after); the phase within STYLE_PHASE_S seconds
  7i. converters — tools/export_torch_checkpoint.py on phase 7's run dir
                 (model_final's EMA weights, the reference's {meta,
                 state_dict} container and nothing else); that state_dict
                 saved bare with DDP's `module.` prefixes and turned back by
                 tools/convert_torch_checkpoint.py: equal bit for bit; the
                 infer CLI on the converted file with --config_path (phase
                 7b's prompt, style PNG and style weights): strokes equal bit
                 for bit to phase 7b's PNG call; a torchvision-layout
                 MobileNetV2 `features` trunk (seeded, BatchNorm statistics
                 drawn) through torch.save and
                 tools/convert_torchvision_mnv2.py, loaded strictly by
                 init_style_extractor on the card: its [2, 14, 1280] vectors
                 against the trunk on the card with the reference pooling
                 (AvgPool2d(3, 3), AdaptiveAvgPool2d((1, 14))) within rtol
                 1e-3, atol 1e-4; none of the five kernels launched; the
                 phase within CONVERT_PHASE_S seconds
  8. train rate — train_steps_per_sec_batch96 with both kernels and with
                 both flags off, in turns (off, on, on, off): CUDA events
                 over 10 steps after one warm-up step
  8b. chunks   — training_args.steps_per_call on the train cell
                 (tools/profile_train.py::best_config), flags off, then on:
                 an eager trainer (train_step, steps 1-20) against a chunked
                 one (train_chunk 16 + 4: the first step eager, then the
                 captured step graph replayed) from one init, an `evaluate`
                 of each (one make_eval_fn step a trainer) before the
                 steps, after 16 and after 20: params,
                 EMA, Adam moments, the [20, 3] rows and the evaluations
                 equal bit for bit, launches equal (9 and 6 a step with the
                 flags, none without); then eager and replayed
                 train_steps_per_sec_batch96 in turns (eager, chunk, chunk,
                 eager; CUDA events over 16 steps), the capture seconds,
                 the peak memory of each trainer, and the idle share of a
                 profiled 16-step chunk beside 4 eager steps; then the same
                 equality with dropout 0.1 at channels 32, flags on (9
                 attention launches a step; the live dropout closes the
                 conv block's gate, as in dhg); last, at channels 32, a
                 captured CUDA graph left in a dead reference cycle (as a
                 stopped server leaves its graphs) and a garbage collection
                 inside the step's capture: the chunk must be captured,
                 with the collector off during the capture
  8c. profile  — dhg's train-step profile, tools/profile_train.py::profile
                 at batch 96 (dhg's default) and steps_per_window 32 (a
                 third of dhg's 96, for the script's time: 2 chunks of 16
                 steps a window; configs/smoke.yml's model, bf16),
                 flags off, then on with a trace_dir: launch counts zeroed
                 before each run and read after (with the flags 9 attention
                 and 6 conv-block launches for each step of the 5 replayed
                 train windows and the trace window and for each forward of
                 the 4 replayed forward-only windows; none without); the
                 report's keys dhg's with mfu_vs_h100_bf16_peak and
                 "device"; flops_per_step equal in both runs; 0 < fwd_only_ms
                 < ms_per_step, bwd_plus_update_ms > 0, the MFU in (0, 1],
                 the HBM fields null; the trace names attention_mma_kernel
                 and conv_block_kernel. Then, flags off and on, one trainer's
                 forward-only graph replayed on step 7's draws against the
                 first row of train_chunk(7, 1) from the same params: within
                 1e-6 relative (bit for bit expected). The phase within
                 PROFILE_PHASE_S seconds
  8d. distill and eval graphs — dhg's jitted distill step and eval step,
                 on the train run's config and model_final (kept from phase
                 7): two Distillers from that teacher (a pair in f32, a
                 pair in bf16, each case from fresh students), eager `step` against
                 make_step_fn's step (the first eager, then the captured
                 graph replayed) on the same 20 draws, batch 96, f32 flags
                 off and on, bf16 flags on: student params, Adam moments,
                 the [20, 3] rows equal bit for bit, launches equal (27
                 attention and 18 conv-block a step with the flags, none
                 without); in f32 eager and replayed steps/s in turns
                 (eager, graph, graph, eager; CUDA events over 4 steps),
                 the capture seconds, each distiller's peak memory and,
                 flags on, the idle share of 8 profiled replayed steps
                 beside 4 eager ones. Then `evaluate` through make_eval_fn on a synthetic
                 validation cache of 200 rows at batch 96 (two batches and
                 a tail of 8: two keys, two captures), the bf16 teacher,
                 flags off and on, against eager eval_batch on the same
                 inputs: every batch bit for bit, launches 9 and 6 a level
                 with the flags; eager against replayed ms for a batch; a
                 weight changed in place read by the next replay, a
                 replaced storage captured again. The phase's seconds
                 against GRAPH_PHASE_S, logged
The weights are random (seed 0); depth is the canonical 2 attention layers.

The kernels line counts the sampler kernels' launches from phase 5c's
replays at batch 96. Stdout ends with the kernels line, the nvidia-smi line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEQ_LEN = 392  # infer_seq_len(24): a 23-character prompt + EOS
TEXT_LEN = 50  # sample_lines' max_text_len
N_STEPS = 60
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # CUDA-core float32 peak, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak, H100 SXM data sheet
# f32-accurate products on the tensor cores as three TF32 products (3xTF32).
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
H100_BYTES_PER_S = 3.35e12
SOURCES = {
    "fused_bottleneck": "dhg_torch/kernels/csrc/bottleneck.cu",
    "fused_encoder_layer": "dhg_torch/kernels/csrc/encoder_layer.cu",
    "fused_attention": "dhg_torch/kernels/csrc/attention.cu",
    "fused_conv_block": "dhg_torch/kernels/csrc/conv_block.cu",
    "fused_unet_t4": "dhg_torch/kernels/csrc/unet_t4.cu",
}
REPLACES = {
    "fused_bottleneck": "dhg/kernels/fused_bottleneck.py:476",
    "fused_encoder_layer": "dhg/kernels/fused_bottleneck.py:242",
    "fused_attention": "dhg/kernels/fused_attention.py:60",
    "fused_conv_block": "dhg/kernels/fused_conv_block.py:76",
    "fused_unet_t4": "dhg/kernels/fused_bottleneck.py:407",
}
INFER_PROMPT = "handwriting on the card"  # 23 characters, as the sampler phases
SERVE_BUCKET = 400  # the serving bucket of a 23-character prompt (392 steps)
# bench_serve levels (clients, requests each): 100 or more latencies a level,
# so that each p99 is a percentile and not the largest of a few.
SERVE_LEVELS = ((1, 100), (16, 16), (64, 8))
LONG_PROMPT = "the quick brown fox jumps over the lazy dog again"  # 49 characters + EOS
LONG_T8 = 101  # infer_seq_len(50) // 8
LONG_SEQ = 8 * LONG_T8  # 808 steps: enc3 at T = 404, enc5 at 202
TRAIN_B, TRAIN_STEPS = 96, 20  # T = 480 (tools/profile_train.py::best_config)
DISTILL_STEPS = 20  # phase 7e: 60 -> 30 from the train run's model_final
MP_STEPS = 5  # phase 7f: steps of each multi-process train run
IAM_FORMS, IAM_SEED = (192, 48), 7  # generated train / validation forms
SAMPLER_KERNELS = ("fused_bottleneck", "fused_encoder_layer", "fused_unet_t4")
# Phase 7g: the keys of each tool's report (dhg's, plus "backend"; profile_stages
# also "kernels"), as dhg/tools/<tool>.py writes them.
TOOL_KEYS = {
    "eval_fewer_steps": {"batch", "seq_len", "mode", "backend", "ms_per_call_60", "rows"},
    "eval_fewer_steps_row": {"n_steps", "stroke_mse", "stroke_max_abs", "pen_flip_rate",
                             "ms_per_call", "lines_per_sec", "speedup_vs_60"},
    "eval_encoder_reuse": {"batch", "seq_len", "mode", "backend", "rows"},
    "eval_encoder_reuse_row": {"reuse_every", "stroke_mse", "stroke_max_abs", "pen_flip_rate",
                               "under_1e-3_bar"},
    "sweep": {"batch", "n_steps", "guidance", "seq_len", "time_s", "denoise_steps_per_sec",
              "ms_per_line", "backend"},
    "bench_hoist": {"batch", "hoist", "ms_per_call", "ms_per_step", "denoise_steps_per_sec",
                    "backend"},
    "profile_stages": {"batch", "seq_len", "backend", "ms_per_step", "stage_sum_ms", "glue_ms",
                       "pct_of_full", "kernels"},
}
# Phase 7h: train_style_trunk at dhg's defaults; tree mode (forms, steps);
# the phase's time limit (seconds).
STYLE_TRUNK = {"steps": 600, "writers": 128, "per_writer": 16, "batch": 64, "width": 384}
STYLE_TREE = {"writers": 32, "steps": 100, "batch": 64, "width": 384}
STYLE_PHASE_S = 120.0
# Phase 8d: steps of each eager / replayed distill pair, steps of each timed
# turn, the validation cache's rows (two batches of 96 and a tail of 8), and
# the phase's time budget (seconds; logged, not fatal).
GRAPH_DISTILL_STEPS, GRAPH_TIMED_STEPS, GRAPH_EVAL_ROWS, GRAPH_PHASE_S = 20, 4, 200, 60.0
GRAPH_PROFILED_STEPS = 8  # phase 8d: replayed distill steps under the profiler
CONVERT_PHASE_S = 15.0  # phase 7i's time limit (seconds)
PROFILE_PHASE_S = 120.0  # phase 8c's time limit (seconds)
PROFILE_WINDOW = 32  # phase 8c: profile's steps_per_window (dhg's default 96, cut for time)
# Phase 8c: the keys of profile's report (dhg's, with the MFU key naming the
# H100's peak, plus "device").
PROFILE_KEYS = {"batch", "backend", "device", "steps_per_sec", "rate_trials", "ms_per_step",
                "samples_per_sec", "flops_per_step", "hbm_bytes_per_step", "achieved_tflops",
                "mfu_vs_h100_bf16_peak", "hbm_bw_gbps", "hbm_bw_util", "fwd_only_steps_per_sec",
                "fwd_only_ms", "bwd_plus_update_ms", "trace_dir"}
RETRIEVAL_KEYS = {"top1_retrieval", "intra_cos_dist", "inter_cos_dist", "intra_over_inter"}
STYLE_KEYS = {
    "train_style_trunk": {"out", "final_ce", "final_acc", "backend"},
    "eval_style_gap": {"n_writers", "per_writer", "chance", "pixel_baseline", "backend"}
    | RETRIEVAL_KEYS,
    "eval_style_gap_ablation": {"mse_A_vs_B", "mse_A_vs_zero", "mse_B_vs_zero",
                                "output_mean_sq", "style_vec_cos_A_B", "backend"},
    "eval_fsd_sensitivity": {"n", "levels", "backend", "random_init", "trained"},
    "eval_fsd_sensitivity_trunk": {"fsd", "noise_floor", "monotone_above_floor",
                                   "range_vs_floor", "feature_std"},
    "eval_style_pathway": {"checkpoint", "output_swap", "val_loss_by_style", "backend"},
}
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
# Ragged T around the conv block kernel's 62-row tile, at training widths:
# (B, T, Cin, Co).
CONV_RAGGED = [(8, 1, 384, 256), (8, 2, 128, 192), (8, 17, 192, 256), (8, 61, 256, 192),
               (8, 62, 384, 256), (8, 63, 192, 128), (8, 125, 128, 128)]


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


def make_inputs(batch, seed, long_first=False):
    """Token ids ([B, 50], a 23-character prompt + EOS, zero-padded; with
    long_first the first prompt is LONG_PROMPT) and style features
    [B, 14, 1280], made from `seed` with numpy."""
    from dhg_torch.data.tokenizer import Tokenizer

    rng = np.random.RandomState(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz ")
    prompts = ["".join(rng.choice(alphabet, 23)) for _ in range(batch)]
    if long_first:
        prompts[0] = LONG_PROMPT
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


def encoder_layer_cases(model, gen):
    """fused_encoder_layer (enc3 and enc5, the model's cached weight tiles)
    against encoder_layer_plain: at seq_len 392 at batch 96 (the sampler's
    shape, both layers 60 times a generate), 1, 8 and 256 (logged: the
    model's gate keeps the kernel to 8 <= B <= 128), and at a 50-token
    prompt's 808 steps at batch 96."""
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels.build import load
    from dhg_torch.models.denoiser import encoder_layer_operands

    bf = torch.bfloat16
    rows = []
    for batch, seq in ((96, SEQ_LEN), (1, SEQ_LEN), (8, SEQ_LEN), (256, SEQ_LEN), (96, LONG_SEQ)):
        _, text, style = make_inputs(batch, seed=40 + batch + seq)
        kvs, films, mask = level_context(model, text, style)
        for name, layer, t, idx in (("enc3", model.enc3, seq // 2, 0),
                                    ("enc5", model.enc5, seq // 4, 1)):
            d, h = layer.d_out, layer.num_heads
            x = torch.randn(batch, t, d, generator=gen, device="cuda").to(bf)
            ops = encoder_layer_operands(layer, x, kvs[idx], films["attn"][idx], mask)
            tiles = model.encoder_layer_tiles(layer)
            label = f"{name} B={batch}" + ("" if seq == SEQ_LEN else f" T={t}")
            b_ms, b_by, gflop, mb = bound(batch, t, d, h, TEXT_LEN)
            row = timed_case("fused_encoder_layer", label,
                             lambda o=ops, h=h, w=tiles: fk.fused_encoder_layer(*o, h, tiles=w),
                             lambda o=ops, h=h: fk.encoder_layer_plain(*o, h), (b_ms, b_by))
            ctas, tc, smem = fk.encoder_layer_layout(t, d, h)
            resident = load().dhg_encoder_layer_max_clusters(t, d, h, TEXT_LEN)
            log(f"    cluster of {ctas} CTAs of {tc} rows, {smem} bytes of shared memory a CTA, "
                f"{resident} clusters resident; {row['bound_ms'] / row['ms']:.4f} of the bound")
            rows.append(dict(row, gflop=gflop, mbytes=mb, t=t, cluster=ctas, rows_per_cta=tc,
                             smem_bytes=smem, max_active_clusters=resident))
    return rows


def kernel_phase(model, report):
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels.build import load

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    t8, d = SEQ_LEN // 8, model.c2 * 2
    nl, heads = model.num_layers, model.att_layers[0].num_heads
    tiles = model.bottleneck_tiles()
    shapes = {}
    for rows8 in (t8, LONG_T8):
        shape = (rows8, model.c3, d, heads, TEXT_LEN)
        resident = load().dhg_bottleneck_max_clusters(*shape)
        smem, ws = fk.bottleneck_layout(*shape)
        shapes[rows8] = dict(ctas=heads, rows_per_cluster=1, smem_bytes=smem,
                             workspace_elems_per_row=ws, max_active_clusters=resident)
        log(f"  bottleneck T8={rows8}: clusters of C = {heads} CTAs (one batch row each, R = 1), "
            f"{smem} bytes of shared memory a CTA, {ws} workspace elements a row "
            f"({'spilled' if ws else 'held in shared memory'}), {resident} clusters resident")
    report["bottleneck_cluster"] = shapes
    for batch, rows8 in ((96, t8), (1, t8), (256, t8), (96, LONG_T8), (1, LONG_T8)):
        _, text, style = make_inputs(batch, seed=batch + rows8)
        kvs, films, mask = level_context(model, text, style)
        x8 = torch.randn(batch, rows8, model.c3, generator=gen, device="cuda").to(bf)
        ops = model.bottleneck_operands(x8, kvs, films, mask)
        label = f"bottleneck B={batch}" + ("" if rows8 == t8 else f" T8={rows8}")
        b_ms, b_by, gflop, mb = bound(batch, rows8, d, heads, TEXT_LEN, cin=model.c3, n_layers=nl)
        row = timed_case("fused_bottleneck", label,
                         lambda o=ops: fk.fused_bottleneck(*o, nl, heads, tiles=tiles),
                         lambda o=ops: fk.bottleneck_plain(*o, nl, heads), (b_ms, b_by))
        log(f"    ({gflop:.3f} GFLOP, {mb:.3f} MB) cluster C = {heads} CTAs, R = 1 row; grid "
            f"{heads} x {batch} CTAs; {b_ms / row['ms']:.4f} of the bound")
        rows.append(dict(row, gflop=gflop, mbytes=mb, cluster=heads, rows_per_cluster=1, t8=rows8))
    rows += encoder_layer_cases(model, gen)
    report["kernel_cases"] = rows
    return rows


class env_flag:
    """Set an environment variable inside a `with` block, then restore it."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.old


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
    with env_flag("DHG_FUSED_BOTTLENECK", "0"):
        eps_p, pen_p = model.denoise(x, None, None, mask, kvs=kvs, films=films)
    report["denoise_eps_max_abs_err"] = compare("denoise eps (kernels vs plain)", eps_k, eps_p)
    report["denoise_pen_max_abs_err"] = compare("denoise pen (kernels vs plain)", pen_k, pen_p)


def t4_work(b, t4, c2, c3, d, l, n_layers):
    """FLOPs of fused_unet_t4 on b rows, every product counted as 2 m n k:
    two ConvBlocks (three k3 convs and an fc each), skip_conv3, att_dense,
    enc5 and the attention layers."""
    t8 = t4 // 2

    def block(cin, co):
        return 2 * t4 * (3 * cin * co + 3 * cin * co // 2 + 3 * co // 2 * co + co * co)

    per_row = block(c2, c3) + block(d, c3) + 2 * t4 * 3 * c3 * d + 2 * t8 * c3 * d
    return (b * per_row + layer_work(b, t4, c3, l)[0]
            + n_layers * layer_work(b, t8, d, l)[0])


def t4_kernel_phase(model, report):
    """fused_unet_t4 (the model's cached weight tiles) against unet_t4_plain
    at batch 1, 8, 96 and 256 (seq_len 392, T4 = 98) and at a 50-token
    prompt's T4 = 202 at batch 96, operands from the canonical model's
    t4_operands at one noise level; each logged with its cluster of CTAs,
    rows a CTA and clusters resident."""
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels.build import load

    gen = torch.Generator(device="cuda").manual_seed(3)
    nl, h8, h5 = model.num_layers, model.att_layers[0].num_heads, model.enc5.num_heads
    tiles, d = model.t4_tiles(), model.c2 * 2
    rows = []
    for batch, seq in ((96, SEQ_LEN), (1, SEQ_LEN), (8, SEQ_LEN), (256, SEQ_LEN), (96, LONG_SEQ)):
        _, text, style = make_inputs(batch, seed=30 + batch + seq)
        kvs, films, mask = level_context(model, text, style)
        t4 = seq // 4
        x4 = torch.randn(batch, t4, model.c2, generator=gen, device="cuda")
        ops = model.t4_operands(x4.to(torch.bfloat16), kvs, films, mask)
        flat = [t for o in ops for t in (o if isinstance(o, list) else [o])]
        flops = t4_work(batch, t4, model.c2, model.c3, d, TEXT_LEN, nl)
        bytes_ = sum(t.numel() * t.element_size() for t in flat) + 2 * batch * t4 * model.c3
        label = f"T4 region B={batch}" + ("" if seq == SEQ_LEN else f" T4={t4}")
        row = timed_case("fused_unet_t4", label,
                         lambda o=ops: fk.fused_unet_t4(*o, nl, h8, h5, tiles=tiles),
                         lambda o=ops: fk.unet_t4_plain(*o, nl, h8, h5),
                         roofline(flops, bytes_, H100_BF16_FLOPS))
        shape = (t4, model.c2, model.c3, d, h5, h8)
        ctas, tc, kr, smem = fk.t4_layout(*shape)
        resident = load().dhg_unet_t4_max_clusters(*shape, TEXT_LEN)
        log(f"    ({flops / 1e9:.4f} GFLOP, {bytes_ / 1e6:.3f} MB) cluster of {ctas} CTAs of "
            f"{tc} rows ({kr} keys staged), {smem} bytes of shared memory a CTA, {resident} "
            f"clusters resident; {row['bound_ms'] / row['ms']:.4f} of the bound")
        rows.append(dict(row, gflop=flops / 1e9, mbytes=bytes_ / 1e6, t4=t4, cluster=ctas,
                         rows_per_cta=tc, smem_bytes=smem, max_active_clusters=resident))
    report["t4_kernel_cases"] = rows
    return rows


def t4_denoise_phase(model, report):
    """Full-width bf16 denoise through fused_unet_t4 (DHG_FUSED_T4=1) == the
    port's plain module path (every kernel flag off)."""
    from dhg_torch.kernels import fused_bottleneck as fk

    _, text, style = make_inputs(96, seed=4)
    kvs, films, mask = level_context(model, text, style, level=20)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(96, SEQ_LEN, 2, generator=gen, device="cuda")
    fk.reset_launch_counts()
    with env_flag("DHG_FUSED_T4", "1"):
        eps_k, pen_k = model.denoise(x, None, None, mask, kvs=kvs, films=films)
    torch.cuda.synchronize()
    if (fk.launches["fused_unet_t4"], fk.launches["fused_bottleneck"],
            fk.launches["fused_encoder_layer"]) != (1, 0, 0):
        fail(f"T4 denoise: launches {fk.launches}, expected one fused_unet_t4 only")
    with env_flag("DHG_FUSED_BOTTLENECK", "0"):
        eps_p, pen_p = model.denoise(x, None, None, mask, kvs=kvs, films=films)
    report["t4_denoise_eps_max_abs_err"] = compare("T4 denoise eps (kernel vs plain)", eps_k, eps_p)
    report["t4_denoise_pen_max_abs_err"] = compare("T4 denoise pen (kernel vs plain)", pen_k, pen_p)


def region_phase(model, report):
    """The T4 kernel's yardstick, at batch 1, 96 and 256 (seq_len 392): the
    default path over the region fused_unet_t4 computes (DiffusionModel.
    t4_region: enc4, enc5, pool, the bottleneck, upsample, skip_conv3, dec3,
    with the default kernels) beside the T4 kernel on the same pooled h2;
    then one whole bf16 denoise step with DHG_FUSED_T4 off and on. CUDA
    events; operands made once outside the timed calls."""
    from dhg_torch.kernels import fused_bottleneck as fk

    gen = torch.Generator(device="cuda").manual_seed(11)
    nl, h8, h5 = model.num_layers, model.att_layers[0].num_heads, model.enc5.num_heads
    rows = []
    for batch in (1, 96, 256):
        _, text, style = make_inputs(batch, seed=50 + batch)
        kvs, films, mask = level_context(model, text, style)
        x4 = torch.randn(batch, SEQ_LEN // 4, model.c2, generator=gen, device="cuda")
        x4 = x4.to(torch.bfloat16)
        x = torch.randn(batch, SEQ_LEN, 2, generator=gen, device="cuda")
        iters = 20 if batch < 256 else 10
        ops, tiles = model.t4_operands(x4, kvs, films, mask), model.t4_tiles()
        row = dict(batch=batch,
                   region_default_ms=cuda_ms(lambda: model.t4_region(x4, mask, kvs, films), iters),
                   t4_kernel_ms=cuda_ms(lambda: fk.fused_unet_t4(*ops, nl, h8, h5, tiles=tiles),
                                        iters))
        for flag in ("0", "1"):
            with env_flag("DHG_FUSED_T4", flag):
                row[f"denoise_step_ms_t4_{flag}"] = cuda_ms(
                    lambda: model.denoise(x, None, None, mask, kvs=kvs, films=films), iters)
        log(f"  B={batch}: region default path {row['region_default_ms']:.4f} ms, T4 kernel "
            f"{row['t4_kernel_ms']:.4f} ms; denoise step flag off {row['denoise_step_ms_t4_0']:.4f}"
            f" ms, on {row['denoise_step_ms_t4_1']:.4f} ms")
        rows.append(row)
    report["t4_yardstick"] = rows


def launch_profile_phase(model, report):
    """profile_sampler.py's 10-step generate at batch 1, 96 and 256,
    DHG_FUSED_T4 off and on, replayed and eager (`_sample`): kernel
    launches, device time and idle share of the call."""
    from dhg_torch.tools.profile_sampler import profile_batch

    keys = ("wall_ms", "device_ms", "idle_share", "n_kernel_launches")
    out = {}
    for flag in ("0", "1"):
        with env_flag("DHG_FUSED_T4", flag):
            for batch in (1, 96, 256):
                r = profile_batch(model, batch, 10, None)
                for kind, f in (("replay", r), ("eager", r["eager"])):
                    out[f"b{batch}_t4_{flag}_{kind}"] = {k: f[k] for k in keys}
                    log(f"  B={batch} DHG_FUSED_T4={flag} {kind}: {f['n_kernel_launches']} "
                        f"launches, device {f['device_ms']:.2f} ms, wall {f['wall_ms']:.1f} ms, "
                        f"idle {f['idle_share']:.3f}")
    report["t4_launch_profile"] = out


def sample_phase(model, label, runs, counted):
    """sample_lines -> generate at each (batch, long_first, expected
    launches): counts of the `counted` kernels zeroed just before each run,
    read just after. Keyed by batch, or "<batch> long" for a batch padded
    to LONG_PROMPT."""
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.inference import sample_lines
    from dhg_torch.kernels import fused_bottleneck as fk

    counts = {}
    for batch, long_first, want in runs:
        prompts, _, style = make_inputs(batch, seed=10 + batch, long_first=long_first)
        gen = torch.Generator(device="cuda").manual_seed(batch)
        fk.reset_launch_counts()
        lines = sample_lines(model, prompts, style, gen, diffusion_mode="new", device="cuda")
        got = tuple(fk.launches[k] for k in counted)
        key = f"{batch} long" if long_first else batch
        counts[key] = got
        shapes = [a.shape for a in lines]
        finite = all(np.isfinite(a).all() for a in lines)
        log(f"  {label} B={key}: launches {dict(zip(counted, got))}; "
            f"shapes {sorted(set(shapes))}; finite {finite}")
        if got != want:
            fail(f"{label} B={key}: launches {got}, expected {want}")
        if shapes != [(infer_seq_len(len(p) + 1), 3) for p in prompts] or not finite:
            fail(f"{label} B={key}: bad output")
    return counts


def generate_phase(model, report):
    counts = sample_phase(model, "generate",
                          ((96, False, (60, 120, 0)), (1, False, (60, 0, 0)),
                           (8, True, (60, 120, 0))),
                          ("fused_bottleneck", "fused_encoder_layer", "fused_unet_t4"))
    report["launches"] = {str(k): v for k, v in counts.items()}
    return counts


def t4_generate_phase(model, report):
    with env_flag("DHG_FUSED_T4", "1"):
        counts = sample_phase(model, "generate (DHG_FUSED_T4=1)",
                              ((96, False, (60, 0, 0)), (1, False, (60, 0, 0))),
                              ("fused_unet_t4", "fused_bottleneck", "fused_encoder_layer"))
    report["t4_launches"] = {str(k): v for k, v in counts.items()}
    return counts


def pool_bytes(pool) -> int | None:
    """Bytes of the segments the caching allocator holds in the private
    pool `pool`, or None where its snapshot names no pool."""
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == tuple(pool))


def eager_sample(model, text, style, seq_len, seed, guidance=None, diffusion_mode="new",
                 n_steps=None, schedule="strided", hoist=None, encoder_reuse=None,
                 sample_seeds=None):
    """(strokes, generator): `_sample`, generate's eager body, on the draws
    of a generator seeded `seed` (or of sample_seeds' streams)."""
    from dhg_torch.core.sampling import per_sample_noise_streams
    from dhg_torch.inference import _sample, beta_table

    n = N_STEPS if n_steps is None else n_steps
    gen, x, z = None, None, None
    if sample_seeds is not None:
        x, z = per_sample_noise_streams(sample_seeds, n, seq_len, "cuda")
    else:
        gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.inference_mode():
        out = _sample(model, text, style, gen, seq_len, beta_table(n, schedule, "cuda"),
                      diffusion_mode, guidance, 1.0, x, z, torch.device("cuda"),
                      hoist or "compact", encoder_reuse)
    return out, gen


# Phase 5c: (label, batch, seq_len, DHG_FUSED_T4, guidance of the three calls,
# generate's other arguments, launches of the replay).
GRAPH_CASES = [
    ("B=1", 1, SEQ_LEN, "0", None, {}, (60, 0, 0)),
    ("B=96", 96, SEQ_LEN, "0", None, {}, (60, 120, 0)),
    ("B=256", 256, SEQ_LEN, "0", None, {}, (60, 0, 0)),
    ("B=8 seq_len 808", 8, LONG_SEQ, "0", None, {}, (60, 120, 0)),
    ("B=1 T4", 1, SEQ_LEN, "1", None, {}, (0, 0, 60)),
    ("B=96 T4", 96, SEQ_LEN, "1", None, {}, (0, 0, 60)),
    ("B=8 guided 1.5, 1.5, 3.0", 8, SEQ_LEN, "0", (1.5, 1.5, 3.0), {}, (120, 240, 0)),
    ("B=8 hoist full", 8, SEQ_LEN, "0", None, {"hoist": "full"}, (60, 120, 0)),
    ("B=8 encoder_reuse 2", 8, SEQ_LEN, "0", None, {"encoder_reuse": 2}, (60, 60, 0)),
    ("B=8 sample_seeds", 8, SEQ_LEN, "0", None, {"sample_seeds": list(range(100, 108))},
     (60, 120, 0)),
    ("B=8 ddim halved 30", 8, SEQ_LEN, "0", None,
     {"diffusion_mode": "ddim", "n_steps": 30, "schedule": "halved"}, (30, 60, 0)),
]


def graphs_phase(report):
    """Phase 5c, on a model of its own (the canonical one, seed 0, bf16),
    so that every key starts unseen: generate on one key three times (the
    eager call, the capture, a replay) at each of GRAPH_CASES, the third
    call against `_sample` on the same draws (bit for bit, the generator
    left in the same state, the same launches); then DHG_FUSED_T4 toggled
    at one shape, and a weight changed in place and one replaced after the
    capture."""
    from dhg_torch.core.graphs import SamplerGraphs
    from dhg_torch.inference import generate, sampler_graphs
    from dhg_torch.models.denoiser import DiffusionModel

    model = DiffusionModel.from_config({"channels": 128, "att_layers_num": 2},
                                       dtype=torch.bfloat16, device="cuda", seed=0)
    graphs = sampler_graphs(model, "cuda")
    t_phase = time.perf_counter()
    rows = {}

    def call(text, style, seq_len, seed, guidance, kw):
        gen = None if "sample_seeds" in kw else torch.Generator(device="cuda").manual_seed(seed)
        return generate(model, text, style, gen, seq_len=seq_len, guidance_scale=guidance,
                        device="cuda", **kw), gen

    def check(label, got, gen, want, want_gen):
        if not torch.equal(got, want):
            fail(f"sampler graphs {label}: the replay differs from the eager _sample "
                 f"(max |diff| {float((got - want).abs().max()):.3g})")
        if gen is not None and not torch.equal(gen.get_state(), want_gen.get_state()):
            fail(f"sampler graphs {label}: the generator's state differs from the eager call's")

    for label, batch, seq_len, flag, guidance, kw, expected in GRAPH_CASES:
        _, text, style = make_inputs(batch, seed=70 + batch, long_first=seq_len == LONG_SEQ)
        scales = guidance or (None, None, None)
        with env_flag("DHG_FUSED_T4", flag):
            key = SamplerGraphs.key(batch, seq_len, kw.get("diffusion_mode", "new"), scales[0],
                                    kw.get("n_steps"), kw.get("schedule", "strided"), None,
                                    kw.get("hoist"), kw.get("encoder_reuse"))
            captures, ms = graphs.captures, []
            for i, g in enumerate(scales):
                if i == 1:
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                (got, gen), launches = counted_run(lambda: call(text, style, seq_len, 9, g, kw))
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 1:
                    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            (want, want_gen), eager_launches = counted_run(lambda: eager_sample(
                model, text, style, seq_len, 9, scales[2], **kw))
        check(label, got, gen, want, want_gen)
        info, n_captures = graphs.info(key), graphs.captures - captures
        if info is None or n_captures != 1:
            fail(f"sampler graphs {label}: {n_captures} captures of the key (expected 1)")
        if launches != eager_launches or launches != expected:
            fail(f"sampler graphs {label}: launches {launches} replayed, {eager_launches} "
                 f"eager, expected {expected}")
        pool = pool_bytes(graphs.pool)
        rows[label] = {"launches": launches, "call_ms": ms, "capture_s": info["capture_s"],
                       "captures": n_captures, "capture_peak_gib": peak,
                       "pool_gib": None if pool is None else pool / 2**30}
        log(f"  {label}: replay equals eager bit for bit; launches {launches}; calls "
            f"(eager, capture, replay) {ms[0]:.1f} / {ms[1]:.1f} / {ms[2]:.1f} ms host; capture "
            f"{info['capture_s']:.3f} s, its peak {peak:.3f} GiB over the call's start; pool "
            f"{'n/a' if pool is None else f'{pool / 2**30:.3f} GiB'}")
        del text, style, got, want

    # DHG_FUSED_T4 off, on, off at B = 96 (both graphs captured above).
    _, text, style = make_inputs(96, seed=70 + 96)
    captures, modes, eager = graphs.captures, [], {}
    for flag, expected in (("0", (60, 120, 0)), ("1", (0, 0, 60)), ("0", (60, 120, 0))):
        with env_flag("DHG_FUSED_T4", flag):
            (got, gen), launches = counted_run(lambda: call(text, style, SEQ_LEN, 9, None, {}))
            if flag not in eager:  # the same inputs and path: one eager call a mode
                eager[flag] = eager_sample(model, text, style, SEQ_LEN, 9)
            check(f"DHG_FUSED_T4={flag}", got, gen, *eager[flag])
        if launches != expected:
            fail(f"sampler graphs DHG_FUSED_T4={flag}: launches {launches}, expected {expected}")
        modes.append(launches)
    if graphs.captures != captures:
        fail(f"sampler graphs: toggling DHG_FUSED_T4 captured {graphs.captures - captures} "
             "graphs (each mode's was captured once before)")
    log(f"  DHG_FUSED_T4 off, on, off at B=96: launches {modes}, each equal to its own path's "
        "eager call, no new capture")

    # A weight changed in place after the capture, then replaced (B = 1): last,
    # since a replaced weight leaves every graph of the model to be captured again.
    _, text, style = make_inputs(1, seed=71)
    weight = model.att_dense.weight  # read through the bottleneck kernel's tiles
    saved, captures = weight.detach().clone(), graphs.captures
    before, _ = call(text, style, SEQ_LEN, 9, None, {})
    with torch.no_grad():
        weight.add_(1e-3)
    got, gen = call(text, style, SEQ_LEN, 9, None, {})
    changed = eager_sample(model, text, style, SEQ_LEN, 9)
    check("after an in-place weight change", got, gen, *changed)
    if torch.equal(got, before) or graphs.captures != captures:
        fail("sampler graphs: the replay did not read the changed weight, or captured again")
    weight.data = weight.data.clone()  # the same values in new storage
    got, gen = call(text, style, SEQ_LEN, 9, None, {})
    check("after a weight's storage was replaced", got, gen, *changed)
    if graphs.captures != captures + 1:
        fail("sampler graphs: replaced weight storage was not captured again")
    with torch.no_grad():
        weight.data = saved
    log("  weights: an in-place change read by the next replay, replaced storage captured "
        "again; both equal eager bit for bit")
    report["sampler_graphs"] = {"cases": rows, "captures": graphs.captures,
                                "phase_s": time.perf_counter() - t_phase}
    log(f"  {graphs.captures} graphs captured; phase {report['sampler_graphs']['phase_s']:.1f} s")
    return {label: r["launches"] for label, r in rows.items()}


def timing_phase(model, report):
    """denoise steps/s at batch 256 and 96 and the p50 line latency at batch
    1, with DHG_FUSED_T4 off (the default) and on: `generate` as a user
    calls it, replaying its graph after two warm-up calls a key (the eager
    call and the capture), and its eager body `_sample` on the same inputs.
    Each batch is timed in the order off, on, on, off (replayed: one call a
    side at 256 and 96, four at 1; eager: one a side, two at 1), so a host
    that drifts through the run weighs on both sides alike; every call is
    reported."""
    from dhg_torch.inference import _sample, beta_table, generate

    def runs(batch, seed):
        _, text, style = make_inputs(batch, seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        beta = beta_table(N_STEPS, "strided", "cuda")

        def eager():
            with torch.inference_mode():
                return _sample(model, text, style, gen, SEQ_LEN, beta, "new", None, 1.0, None,
                               None, torch.device("cuda"))

        return {"replay": lambda: generate(model, text, style, gen, seq_len=SEQ_LEN,
                                           device="cuda"),
                "eager": eager}

    def call_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    order = ("0", "1", "1", "0")
    calls = {}
    for batch, seed, per_side in ((256, 5, (1, 1)), (96, 7, (1, 1)), (1, 6, (4, 2))):
        fns = runs(batch, seed)
        for flag in ("0", "1"):
            with env_flag("DHG_FUSED_T4", flag):
                fns["replay"]()
                fns["replay"]()
        for kind, n in zip(("replay", "eager"), per_side):
            seq = []
            for flag in order:
                with env_flag("DHG_FUSED_T4", flag):
                    seq += [(flag, call_ms(fns[kind])) for _ in range(n)]
            calls[f"{batch} {kind}"] = seq
            log(f"  B={batch} {kind} ms per 60-step call in turn (flag off/on): "
                + ", ".join(f"{'on' if f == '1' else 'off'} {ms:.1f}" for f, ms in seq))
    report["t4_timing_calls"] = calls
    for kind in ("replay", "eager"):
        for flag in ("0", "1"):
            def ms(batch):
                return [m for f, m in calls[f"{batch} {kind}"] if f == flag]

            ms256, ms96 = statistics.mean(ms(256)), statistics.mean(ms(96))
            lat = [m / 1e3 for m in ms(1)]
            p50 = statistics.median(lat)
            steps256, steps96 = 256 * N_STEPS / (ms256 / 1e3), 96 * N_STEPS / (ms96 / 1e3)
            log(f"  {kind} DHG_FUSED_T4={flag}: batch 256 {ms256:.1f} ms per 60-step call (mean "
                f"of 2) -> {steps256:.1f} denoise steps/s; batch 96 {ms96:.1f} ms -> "
                f"{steps96:.1f} steps/s; batch 1 p50 line latency {p50 * 1e3:.2f} ms "
                f"({len(lat)} calls)")
            tag = ("" if kind == "replay" else "_eager") + ("" if flag == "0" else "_t4")
            report.update({f"denoise_steps_per_sec_b256{tag}": steps256,
                           f"ms_per_call_b256{tag}": ms256,
                           f"denoise_steps_per_sec_b96{tag}": steps96,
                           f"ms_per_call_b96{tag}": ms96,
                           f"p50_line_latency_s_b1{tag}": p50, f"line_latencies_s_b1{tag}": lat})


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


def conv_block_operands(b, t, cin, co, gen):
    """(the 14 f32 operands, x in f32 [b, t, cin]) of one ConvBlock at its
    initialisation's scale, FiLM per row."""
    c2 = co // 2

    def r(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device="cuda")

    ops = [r(3, cin, co, scale=(3 * cin) ** -0.5), r(co, scale=0.1),
           r(3, cin, c2, scale=(3 * cin) ** -0.5), r(c2, scale=0.1),
           r(3, c2, co, scale=(3 * c2) ** -0.5), r(co, scale=0.1),
           r(co, co, scale=co ** -0.5), r(co, scale=0.1)]
    for c in (c2, co, co):  # FiLM gamma, beta per row
        ops += [r(b, c, scale=0.1, base=1.0), r(b, c, scale=0.1)]
    return ops, r(b, t, cin)


def conv_block_bound(b, t, cin, co, bf16_x, rate):
    """(bound_ms, bound_by) of one ConvBlock: its products' flops over `rate`
    (the skip conv of a bf16 x takes two TF32 products, not three, so it
    counts 2/3 of its flops at the 3xTF32 rate) against its bytes (x, out,
    weights and per-row FiLM read or written once) over HBM."""
    c2 = co // 2
    skip, rest = 2 * b * t * 3 * cin * co, 2 * b * t * (3 * cin * c2 + 3 * c2 * co + co * co)
    if bf16_x and rate == H100_3XTF32_FLOPS:
        skip = skip * 2 / 3
    elem = 2 if bf16_x else 4
    weights = 3 * cin * co + co + 3 * cin * c2 + c2 + 3 * c2 * co + co + co * co + co
    bytes_ = elem * b * t * (cin + co) + 4 * (weights + b * (c2 + co + co) * 2)
    return roofline(skip + rest, bytes_, rate)


def train_kernel_phase(report):
    """fused_attention and fused_conv_block at every training-path shape."""
    import torch.nn.functional as F

    from dhg_torch.kernels import build, fused_attention as fa
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
    lib = build.load()
    layouts = {}
    for label, t, cin, co in TRAIN_CONV:
        ops, x32 = conv_block_operands(b, t, cin, co, gen)
        tile, threads, slots, smem = fc.conv_block_layout(cin, co)
        for dt, tol, med in ((bf, 0.05, 5e-3), (torch.float32, 1e-4, 1e-4)):
            x = x32.to(dt)
            resident = lib.dhg_conv_block_ctas_per_sm(cin, co, int(dt == bf))
            ctas = -(-t // tile) * b
            log(f"  conv block {label} {str(dt)[6:]}: {ctas} CTAs of {tile} rows and {threads} "
                f"threads, {slots} ring slots, {smem} bytes; {resident} an SM resident")
            if resident < 1:
                fail(f"conv block {label}: no CTA fits on an SM")
            row = timed_case(
                "fused_conv_block", f"conv block {label} {str(dt)[6:]} B={b}",
                lambda: fc.fused_conv_block(x, *ops), lambda: fc.conv_block_plain(x, *ops),
                conv_block_bound(b, t, cin, co, dt == bf, H100_3XTF32_FLOPS),
                tol=tol, median_bar=med,
            )
            layouts[f"{label} {str(dt)[6:]}"] = dict(ctas=ctas, tile=tile, threads=threads,
                                                     slots=slots, smem_bytes=smem,
                                                     ctas_per_sm=resident)
            rows.append(dict(row, per_step=1 if dt == bf else 0, shape=[b, t, cin, co],
                             bound_cuda_core_ms=conv_block_bound(b, t, cin, co, dt == bf,
                                                                 H100_F32_FLOPS)[0]))
    report["conv_block_layouts"] = layouts
    for rb, t, cin, co in CONV_RAGGED:
        ops, x32 = conv_block_operands(rb, t, cin, co, gen)
        for dt, tol, med in ((bf, 0.05, 5e-3), (torch.float32, 1e-4, 1e-4)):
            x = x32.to(dt)
            got = fc.fused_conv_block(x, *ops)
            torch.cuda.synchronize()
            err = compare(f"conv block ragged T={t} [{cin} -> {co}] {str(dt)[6:]} B={rb}", got,
                          fc.conv_block_plain(x, *ops), tol, med)
            rows.append(dict(kernel="fused_conv_block", case=f"ragged T={t} {str(dt)[6:]}",
                             max_abs_err=err, per_step=0, shape=[rb, t, cin, co]))
    # f32-accurate products: against the plain version in float64 at dec3's
    # widths (a single TF32 pass misses this by an order of magnitude).
    ops, x = conv_block_operands(8, 120, 384, 256, gen)
    ref = fc.conv_block_plain(x.double(), *[o.double() for o in ops])
    scale = float(ref.abs().max())
    rel = float((fc.fused_conv_block(x, *ops).double() - ref).abs().max()) / scale
    plain_rel = float((fc.conv_block_plain(x, *ops).double() - ref).abs().max()) / scale
    log(f"  conv block dec3 f32 against float64: kernel {rel:.3g}, plain f32 {plain_rel:.3g} "
        f"of the output's scale {scale:.3g} (bar 1e-5)")
    if not rel <= 1e-5:
        fail("fused_conv_block: f32 output not within 1e-5 of a float64 reference")
    report["conv_block_f64_rel_err"] = dict(kernel=rel, plain_f32=plain_rel)
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


def plain_train_run(tmp):
    """The run dir of a 20-step run of the train cell with both train flags
    off, for the serve phase, which runs beside the kernels' build."""
    from pathlib import Path

    from dhg_torch.config import DLConfig
    from dhg_torch.tools.profile_train import best_config
    from dhg_torch.train import main as train_main

    set_train_flags(False)
    cfg = DLConfig(best_config(Path(tmp) / "serve_run", TRAIN_STEPS, TRAIN_B))
    return train_main(cfg, device="cuda").exp_dir


def train_phase(report, tmp):
    from dhg_torch.config import DLConfig
    from dhg_torch.inference import sample_lines
    from dhg_torch.kernels import fused_attention as fa
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels import fused_conv_block as fc
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools.profile_train import best_config
    from dhg_torch.train import main as train_main

    set_train_flags(True)
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
    return got, run


def infer_phase(run, tmp, report):
    """The infer CLI on the train phase's run dir (f32, as dhg's infer): a
    style PNG written with the port's own writer, one 23-character line to
    a PNG, then the same prompt wrapped at 12 characters to an SVG."""
    from dhg_torch.data.images import read_png
    from dhg_torch.inference import main as infer_main
    from dhg_torch.kernels import fused_attention as fa
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels import fused_conv_block as fc

    style = scribble_png(os.path.join(tmp, "style.png"), 9)
    prompt = INFER_PROMPT
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "style_trunk_synth.npz")
    common = [f"--prompt={prompt}", f"--source={style}", f"--experiment_path={run}",
              f"--style_weights={weights}"]
    outs = {}
    for fmt, extra in (("png", []), ("svg", ["--wrap=12"])):
        out = os.path.join(tmp, f"infer_{fmt}")
        reset_all_counts()
        t0 = time.perf_counter()
        strokes = infer_main([*common, f"--output={out}", f"--format={fmt}", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernel_launches = sum(fk.launches.values()) + sum(fa.launches.values()) + sum(
            fc.launches.values())
        path = f"{out}.{fmt}"
        ok = os.path.isfile(path) and np.isfinite(strokes).all() and kernel_launches == 0
        if fmt == "png" and ok:
            img = read_png(path)
            ok = img.dtype == np.uint8 and img.size > 0 and (img == 0).any()
            log(f"  infer {prompt!r} -> {os.path.basename(path)}: {img.shape[1]}x{img.shape[0]} "
                f"px, strokes {strokes.shape}, {wall:.2f} s")
        elif ok:
            ok = open(path).read().startswith("<svg")
            log(f"  infer --wrap=12 -> {os.path.basename(path)}: strokes {strokes.shape}, "
                f"{wall:.2f} s")
        if not ok:
            fail(f"infer ({fmt}): bad output or a bf16 kernel launched ({kernel_launches})")
        outs[fmt] = dict(shape=list(strokes.shape), wall_s=wall)
        if fmt == "png":
            png_strokes = strokes
    report["infer"] = outs
    return style, png_strokes


def scribble_png(path, seed):
    """A synthetic style image (dark scribbles on a white page) written with
    the port's own PNG writer."""
    from dhg_torch.data.images import write_png

    rng = np.random.RandomState(seed)
    page = np.full((80, 320), 245, np.uint8)
    for _ in range(40):
        r, c = rng.randint(10, 70), rng.randint(10, 290)
        page[r - 2:r + 3, c:c + rng.randint(4, 20)] = rng.randint(0, 80)
    write_png(path, page)
    return path


def batch_timeline(log_rows):
    """What a level's batches were made of, from GenerationService.batch_log:
    their sizes; the share of requests already queued when the batcher took
    their batch's first request, the share that came in the batching window
    after it, and the share that arrived while the batch before sampled; the
    mean sampling time; the mean time the batcher waited between one
    batch's end and taking the next; and the service's own latency
    percentiles, each request's submit to its batch's end."""
    from dhg_torch.tools.bench_serve import percentiles_ms

    n = sum(len(r["submits"]) for r in log_rows) or 1
    queued = sum(t <= r["taken"] for r in log_rows for t in r["submits"])
    window = sum(r["taken"] < t <= r["start"] for r in log_rows for t in r["submits"])
    during_prev = sum(p["start"] < t <= p["end"]
                      for p, r in zip(log_rows, log_rows[1:]) for t in r["submits"])
    idle = [r["taken"] - p["end"] for p, r in zip(log_rows, log_rows[1:])]
    return {
        "batches": len(log_rows),
        "sizes": [len(r["submits"]) for r in log_rows],
        "mean_batch": n / max(len(log_rows), 1),
        "queued_share": queued / n,
        "window_share": window / n,
        "during_prev_share": during_prev / n,
        "sample_ms_mean": statistics.mean(r["end"] - r["start"] for r in log_rows) * 1e3,
        "idle_ms_mean": statistics.mean(idle) * 1e3 if idle else 0.0,
        "service": percentiles_ms([r["end"] - t for r in log_rows for t in r["submits"]]),
    }


def serve_phase(run, tmp, report):
    """The serving runtime on a run dir's model_final (f32, as dhg's
    serve): warm-up of dhg's default grid (buckets 200 and 400, modes new and
    standard, max_batch 16: 20 captured graphs), one replay against the eager
    generate bit for bit at batch 1 and 16, replay and eager calls timed and
    profiled, bench_serve's run_level at 1 x 100, 16 x 16 and 64 x 8 (clients
    x requests; captures must not move; each level's batches read from the
    service's batch_log), a page request, then the CLI as a subprocess
    drained by SIGTERM. Kernel counts zeroed before and read after: this
    path runs no kernel (f32)."""
    import signal

    from dhg_torch.core.sampling import per_sample_noise_streams
    from dhg_torch.data.tokenizer import Tokenizer
    from dhg_torch.inference import generate, wrap_text
    from dhg_torch.kernels import fused_attention as fa
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels import fused_conv_block as fc
    from dhg_torch.serve import GenerationService, serve
    from dhg_torch.tools.bench_serve import _post, run_level
    from dhg_torch.tools.profile_sampler import profile_call

    out = {}
    t_phase = time.perf_counter()
    draw_ms = {}
    for b in (16, 256):  # the rows' noise streams on the host, bucket 400, 60 steps
        t0 = time.perf_counter()
        per_sample_noise_streams(range(b), N_STEPS, SERVE_BUCKET, "cpu")
        draw_ms[b] = (time.perf_counter() - t0) * 1e3
    log(f"  noise streams on the host (60 steps, T {SERVE_BUCKET}): B=16 {draw_ms[16]:.2f} ms, "
        f"B=256 {draw_ms[256]:.2f} ms")
    out["noise_draw_host_ms"] = draw_ms

    sources = ",".join(scribble_png(os.path.join(tmp, f"serve_style{i}.png"), 20 + i)
                       for i in range(2))
    reset_all_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = GenerationService.from_experiment(str(run), source=sources, device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    httpd = serve(svc, port=0)
    warm_s = time.perf_counter() - t0
    captures = svc.stats_snapshot()["captures"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  from_experiment (model_final, 2 style PNGs) {load_s:.1f} s; "
        f"warm-up (buckets 200 and 400, modes new and standard, max_batch 16): {captures} "
        f"graphs captured in {warm_s:.1f} s; peak device memory {peak_gb:.3f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved); bank of "
        f"{svc.n_styles} styles")
    if captures != 20 or svc.n_styles != 2:
        fail(f"serve: {captures} graphs after warm-up (want 20), {svc.n_styles} styles")
    out.update(load_s=load_s, warmup_s=warm_s, graphs=captures, peak_mem_gib=peak_gb)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        tokens = Tokenizer().encode(INFER_PROMPT)
        calls = {}
        for b in (1, 16):
            seeds = list(range(1000, 1000 + b))
            text = np.zeros((b, TEXT_LEN), np.int64)
            text[:, :len(tokens)] = tokens
            style = svc.styles[:1].expand(b, 14, 1280)

            def replay():
                return svc._run_bucket([tokens] * b, seeds, SERVE_BUCKET, "new", None)

            def eager():
                return generate(svc.model, text, style, seq_len=SERVE_BUCKET,
                                sample_seeds=seeds, device="cuda").cpu().numpy()

            got, want = replay(), eager()
            gap = float(np.abs(got - want).max())
            log(f"  B={b}: replay against eager generate on the same draws: "
                f"{'bit-identical' if np.array_equal(got, want) else f'max |diff| {gap:.3g}'}")
            if not np.array_equal(got, want) or not np.isfinite(got).all():
                fail(f"serve: replay at B={b} is not the eager generate's result")
            row = {}
            for label, fn in (("replay", replay), ("eager", eager)):
                ms = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                prof = profile_call(fn)
                prof_s = time.perf_counter() - t0
                row[label] = dict(ms=ms, **{k: prof[k] for k in ("wall_ms", "device_ms",
                                                                 "idle_share",
                                                                 "n_kernel_launches")})
                log(f"  B={b} {label}: {', '.join(f'{m:.1f}' for m in ms)} ms a call (host "
                    f"clock, draws and copies included); profiled: wall {prof['wall_ms']:.1f} "
                    f"ms, device {prof['device_ms']:.2f} ms, idle {prof['idle_share']:.3f}, "
                    f"{prof['n_kernel_launches']} kernels (the profiler took {prof_s:.1f} s)")
            calls[b] = row
        out["calls"] = calls
        if svc.stats_snapshot()["captures"] != captures:
            fail("serve: the checks captured a graph")

        gaps = []  # a solo request's client latency beside the service's own "ms"
        for seed in range(1, 6):
            t0 = time.perf_counter()
            _, body = _post(url + "/generate", {"prompt": INFER_PROMPT, "seed": seed})
            gaps.append(((time.perf_counter() - t0) * 1e3, body["ms"]))
        log("  solo requests, client ms / service ms (submit to result): "
            + ", ".join(f"{c:.1f} / {m:.1f}" for c, m in gaps))
        out["solo_client_vs_service_ms"] = gaps
        levels = []
        for i, (clients, requests) in enumerate(SERVE_LEVELS):
            t_level = time.perf_counter()
            res = run_level(url, clients, requests, INFER_PROMPT, seed0=10_000 * (i + 1))
            res["captures"] = svc.stats_snapshot()["captures"]
            res.update(batch_timeline([r for r in svc.batch_log if r["taken"] >= t_level]))
            levels.append(res)
            log(f"  {clients} clients x {requests}: {res['lines_per_s']} lines/s, p50 "
                f"{res['p50_ms']} ms, p99 {res['p99_ms']} ms, errors {res['errors']}, "
                f"captures {res['captures']}; {res['batches']} batches, mean size "
                f"{res['mean_batch']:.2f}, sizes in order (first 24) {res['sizes'][:24]}, "
                f"by size {dict(sorted(collections.Counter(res['sizes']).items()))}")
            log(f"    of the level's requests: {res['queued_share']:.3f} were queued when the "
                f"batcher took their batch's first request, {res['window_share']:.3f} came in "
                f"its {svc.batch_window * 1e3:.0f} ms window; "
                f"{res['during_prev_share']:.3f} arrived while the batch before sampled; "
                f"sampling {res['sample_ms_mean']:.1f} ms a batch on average; batcher idle "
                f"between batches {res['idle_ms_mean']:.2f} ms on average; in the service "
                f"(submit to batch end) p50 {res['service']['p50_ms']} ms, p99 "
                f"{res['service']['p99_ms']} ms")
            if res["errors"] or res["ok"] != clients * requests or res["captures"] != captures:
                fail(f"serve: level {clients}: {res}")
            if sum(res["sizes"]) != clients * requests:
                fail(f"serve: level {clients}: the batch log holds {sum(res['sizes'])} requests")
        out["levels"] = levels

        prompt = INFER_PROMPT + " served as a page"
        status, body = _post(url + "/generate", {"prompt": prompt, "seed": 3, "wrap": 20})
        page = np.asarray(body.get("strokes", []))
        log(f"  page request (wrap 20): status {status}, {body.get('lines')} lines, strokes "
            f"{page.shape}, {body.get('ms')} ms")
        if (status != 200 or body["lines"] != len(wrap_text(prompt, 20)) or page.ndim != 2
                or not np.isfinite(page).all()):
            fail("serve: page request failed")
        if svc.stats_snapshot()["captures"] != captures:
            fail("serve: live traffic captured a graph")
        out["stats"] = svc.stats_snapshot()
    finally:
        httpd.shutdown()
        svc.shutdown()
        httpd.server_close()
    kernel_launches = sum(fk.launches.values()) + sum(fa.launches.values()) + sum(
        fc.launches.values())
    if kernel_launches:
        fail(f"serve: {kernel_launches} kernel launches on the f32 path")
    del svc
    torch.cuda.empty_cache()

    log_path = os.path.join(tmp, "serve_cli.log")
    cmd = [sys.executable, "-u", "-m", "dhg_torch.serve", f"--experiment_path={run}",
           "--warmup_buckets=400", "--warm_modes=new", "--max_batch=4", "--port=0"]
    t0 = time.perf_counter()
    with open(log_path, "wb") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        port = None
        while time.perf_counter() - t0 < 180 and proc.poll() is None:
            text = open(log_path).read()
            if "dhg_torch serving on 127.0.0.1:" in text:
                port = int(text.split("dhg_torch serving on 127.0.0.1:")[1].split()[0])
                break
            time.sleep(0.2)
        if port is None:
            fail(f"serve CLI never announced its port:\n{open(log_path).read()[-2000:]}")
        up_s = time.perf_counter() - t0
        status, body = _post(f"http://127.0.0.1:{port}/generate", {"prompt": INFER_PROMPT})
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        text = open(log_path).read()
        drained = "dhg_torch server stopped (drained)" in text
        log(f"  CLI (--warmup_buckets=400 --warm_modes=new --max_batch=4): serving after "
            f"{up_s:.1f} s, request status {status}, SIGTERM -> exit {rc}, drained {drained}")
        if status != 200 or rc != 0 or not drained:
            fail(f"serve CLI: status {status}, exit {rc}:\n{text[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["cli_up_s"] = up_s
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  serve phase {out['phase_s']:.1f} s (the CLI {time.perf_counter() - t0:.1f} s)")
    report["serve"] = out


def iam_phase(report, tmp):
    """The IAM data path: a generated tree, both caches built on the card
    (native scanner required) and loaded again without a rebuild, 20
    training steps on them with both train-path kernels, the tail
    checkpoints averaged, then the eval and metrics CLIs."""
    import contextlib
    import io
    from pathlib import Path

    from dhg_torch import eval as eval_mod
    from dhg_torch.config import DLConfig
    from dhg_torch.data import strokes as stroke_parse
    from dhg_torch.data.iam import load_or_build_cache
    from dhg_torch.eval import main as eval_main
    from dhg_torch.kernels import fused_attention as fa
    from dhg_torch.kernels import fused_bottleneck as fk
    from dhg_torch.kernels import fused_conv_block as fc
    from dhg_torch.metrics import main as metrics_main
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.native import get_lib
    from dhg_torch.tools import gen_iam_scale
    from dhg_torch.tools.average_checkpoints import main as average_main
    from dhg_torch.tools.profile_train import best_config
    from dhg_torch.train import iam_cache_kwargs
    from dhg_torch.train import main as train_main

    t_phase = time.perf_counter()
    out: dict = {}
    root = Path(tmp) / "iam_tree"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tree = gen_iam_scale.main(root=str(root), train_forms=IAM_FORMS[0],
                                  val_forms=IAM_FORMS[1], seed=IAM_SEED)
    out["tree"] = dict(tree, gen_wall_s=time.perf_counter() - t0)
    log(f"  tree: {tree['train_forms']} + {tree['val_forms']} forms, {tree['lines']} lines, "
        f"{tree['disk_mb']} MB, {out['tree']['gen_wall_s']:.1f} s")

    cfg = best_config(Path(tmp) / "iam_runs", TRAIN_STEPS, TRAIN_B)
    cfg["experiment"].update(data_dir=str(root), splits_file=str(root / "splits.json"))
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "style_trunk_synth.npz")
    cfg["dataset_args"].update(img_height=96, img_width=1400, style_weights=weights)
    cfg["training_args"].update(dataset="iam", cache_dir=str(Path(tmp) / "iam_cache"),
                                max_files=None, keep_checkpoints=None, val_freq=10)
    cfg = DLConfig(cfg)
    if get_lib() is None:
        fail("iam: the native stroke scanner did not build (g++)")
    caches = {}
    for kind in ("train", "validation"):
        kwargs = iam_cache_kwargs(cfg, kind, "cuda")
        stroke_parse.parsed.clear()
        torch.cuda.reset_peak_memory_stats()
        built: dict = {}
        t0 = time.perf_counter()
        cache = load_or_build_cache(**kwargs, stats=built)
        wall = time.perf_counter() - t0
        parsed = dict(stroke_parse.parsed)
        if "built" not in built:
            fail(f"iam {kind}: the cache was not built afresh ({built})")
        if parsed.get("fallback", 0) or not parsed.get("native"):
            fail(f"iam {kind}: stroke files not parsed by the native scanner ({parsed})")
        n = len(cache)
        lines = n + sum(built.get(k, 0) for k in ("dropped_text", "dropped_strokes",
                                                  "dropped_image", "dropped_missing"))
        ok = (cache.strokes.shape == (n, 480, 3) and cache.style.shape == (n, 14, 1280)
              and np.isfinite(cache.strokes).all() and np.isfinite(cache.style).all())
        if not ok:
            fail(f"iam {kind}: bad cache arrays")
        built.update(parsed=parsed, wall_s=wall, lines=lines, lines_per_s=lines / wall,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        log(f"  {kind}: {n} of {lines} lines kept (dropped: text {built.get('dropped_text', 0)}, "
            f"strokes {built.get('dropped_strokes', 0)}, image {built.get('dropped_image', 0)}); "
            f"native parses {parsed.get('native', 0)}; forms {built['forms_s']:.2f} s wall "
            f"(CPU: parse {built.get('parse_s', 0):.2f} s, images {built.get('image_s', 0):.2f} s "
            f"over {built['workers']} threads), style {built['style_s']:.2f} s, save "
            f"{built['save_s']:.2f} s; {built['lines_per_s']:.1f} lines/s; peak "
            f"{built['peak_mem_gb']:.3f} GiB")
        again: dict = {}
        t0 = time.perf_counter()
        reloaded = load_or_build_cache(**kwargs, stats=again)
        same = (reloaded.sample_ids == cache.sample_ids
                and np.array_equal(reloaded.strokes, cache.strokes)
                and np.array_equal(reloaded.style, cache.style))
        if "loaded" not in again or "built" in again or not same:
            fail(f"iam {kind}: the second call did not load the saved cache ({again})")
        built["reload_s"] = time.perf_counter() - t0
        log(f"  {kind}: reloaded {Path(again['loaded']).name} in {built['reload_s']:.2f} s")
        out[kind] = built
        caches[kind] = cache

    # Every eval step made (make_eval_fn), to read its captures: on the card
    # the val_freq passes and the eval CLI replay one graph a batch shape.
    made: list = []
    real_make_eval = eval_mod.make_eval_fn

    def spy_make_eval(*args, **kwargs):
        made.append(real_make_eval(*args, **kwargs))
        return made[-1]

    def eval_graphs(n_rows: int, batch: int) -> dict:
        """The one step made since the last call, against one capture a
        batch shape (the tail its own); fatal unless it replayed."""
        want = len({min(batch, n_rows - i) for i in range(0, n_rows, batch)})
        steps, caps = list(made), [getattr(m, "captures", None) for m in made]
        made.clear()
        if len(steps) != 1 or not isinstance(steps[0], eval_mod.EvalGraphs) or caps != [want]:
            fail(f"iam: eval steps {steps} with captures {caps}, expected one EvalGraphs "
                 f"with {want}")
        return {"captures": caps[0], "keys": len(steps[0].graphs)}

    set_train_flags(True)
    reset_all_counts()
    eval_mod.make_eval_fn = spy_make_eval
    try:
        t0 = time.perf_counter()
        trainer = train_main(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eval_mod.make_eval_fn = real_make_eval
    run = trainer.exp_dir
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    vals = [r["val_loss"] for r in rows if "val_loss" in r]
    # Every forward with the flags on launches 9 and 6: the train steps and
    # the validation passes (steps 10 and 20, 6 levels a batch).
    n_val = len(caches["validation"])
    val_forwards = 2 * -(-n_val // min(TRAIN_B, n_val)) * 6
    forwards = TRAIN_STEPS + val_forwards
    got = (fa.launches["fused_attention"], fc.launches["fused_conv_block"],
           fk.launches["fused_bottleneck"] + fk.launches["fused_encoder_layer"])
    want = (9 * forwards, 6 * forwards, 0)
    set_train_flags(False)
    val_graphs = eval_graphs(n_val, min(TRAIN_B, n_val))
    log(f"  training: {TRAIN_STEPS} steps + {val_forwards} validation forwards in {wall:.1f} s; "
        f"launches {got} (want {want}); losses {losses}; val losses {vals}; the val passes' "
        f"step {val_graphs}")
    if got != want:
        fail(f"iam train: launches {got}, expected {want}")
    if len(losses) != TRAIN_STEPS // 5 or len(vals) != 2 or not np.all(np.isfinite(losses + vals)):
        fail("iam train: bad metrics.jsonl (losses or the val_freq pass)")
    out["training"] = dict(wall_s=wall, losses=losses, val_losses=vals, launches=list(got),
                           forwards=forwards, val_graphs=val_graphs)

    soup = run / "soup_10_20"
    with contextlib.redirect_stdout(io.StringIO()) as said:
        average_main(["--dst", str(soup), "--experiment_path", str(run)])
    a, b = (torch.load(run / f"checkpoint_{k}", map_location="cpu", weights_only=True)
            for k in (10, 20))
    mean = torch.load(soup, map_location="cpu", weights_only=True)
    err = max((mean["state_dict"][k].double() - (a["state_dict"][k].double()
               + b["state_dict"][k].double()) / 2).abs().max().item() for k in a["state_dict"])
    model = DiffusionModel.load(soup, device="cuda")
    finite = all(torch.isfinite(p).all() for p in model.parameters())
    log(f"  {said.getvalue().strip()}; max |soup - mean| {err:.3g}; loads, finite {finite}")
    if err > 1e-6 or not finite or "ema_state_dict" not in mean:
        fail("iam: the averaged checkpoint is wrong")
    del model

    eval_mod.make_eval_fn = spy_make_eval
    try:
        with contextlib.redirect_stdout(io.StringIO()) as said:
            t0 = time.perf_counter()
            val = eval_main([f"--experiment_path={run}", f"--checkpoint_path={soup}",
                             "--split=validation", "--batch_size=96"])
            eval_s = time.perf_counter() - t0
    finally:
        eval_mod.make_eval_fn = real_make_eval
    line = said.getvalue().strip()
    cli_graphs = eval_graphs(n_val, min(96, n_val))
    log(f"  eval CLI (the soup, validation): {line!r}, {eval_s:.1f} s; its step {cli_graphs}")
    if not line.startswith("Val Loss: ") or "| Val Score: " not in line or not np.isfinite(
            val).all():
        fail(f"iam: bad eval line {line!r}")
    out["eval"] = dict(line=line, values=[float(v) for v in val], wall_s=eval_s,
                       graphs=cli_graphs)

    with contextlib.redirect_stdout(io.StringIO()) as said:
        t0 = time.perf_counter()
        scores = metrics_main([f"--experiment_path={run}", "--n_samples=64", "--batch_size=32"])
        metrics_s = time.perf_counter() - t0
    ks = scores["ks"]
    log(f"  metrics CLI: n {scores['n']}, sampler {scores['sampler']}, ks_mean {ks['ks_mean']}, "
        f"FSD {scores['frechet_style_distance']} (real vs real "
        f"{scores.get('fsd_real_vs_real')}), {metrics_s:.1f} s")
    if (json.loads(said.getvalue().strip().splitlines()[-1]) != scores or scores["n"] != 64
            or not np.all(np.isfinite(list(ks.values())))
            or not np.isfinite(scores["frechet_style_distance"])):
        fail(f"iam: bad metrics result {scores}")
    out["metrics"] = dict(scores, wall_s=metrics_s)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  iam phase {out['phase_s']:.1f} s")
    report["iam"] = out
    return {"tree": root, "run": run, "cache": out["train"]["built"],
            "rows": len(caches["train"])}


def kernel_launches() -> dict:
    from dhg_torch.kernels.runtime import launch_counts

    return launch_counts()


def distill_phase(run, tmp, report):
    """Phase 7e: dhg_torch.distill.main (f32, as dhg's CLI) from the train
    run's model_final, 60 -> 30 for DISTILL_STEPS steps, with both train
    flags off and then on on the same draws (launch counts zeroed before
    each CLI run and read after); the infer CLI on the student with no
    flags; tools/probe_distill --multi=1 (f32); then the probe's three
    generate calls on teacher and student loaded in bf16 at B = 8, where
    the sampler kernels run."""
    import contextlib
    import io
    from pathlib import Path

    from dhg_torch import distill, inference
    from dhg_torch.config import DLConfig
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools import probe_distill

    t_phase = time.perf_counter()
    out: dict = {}
    # Each step's loss triple, a CUDA event after it and whether the step's
    # graph was captured by then, read once the run ends: the recorder wraps
    # the step distill() takes from make_step_fn.
    steps: list = []
    real_make = distill.Distiller.make_step_fn

    def recorded_make(self, data):
        step = real_make(self, data)

        def recorded(d):
            metrics = step(d)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            steps.append((metrics, ev, self.graph is not None and self.graph.graph is not None))
            return metrics

        return recorded

    distill.Distiller.make_step_fn = recorded_make
    runs = {}
    try:
        for label in ("off", "on"):
            set_train_flags(label == "on")
            steps.clear()
            reset_all_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                student = distill.main([f"--experiment_path={run}", f"--steps={DISTILL_STEPS}",
                                        f"--experiment.work_dir={tmp}/distill_{label}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernel_launches()
            losses = [m.tolist() for m, _, _ in steps]
            rate = (len(steps) - 1) / (steps[0][1].elapsed_time(steps[-1][1]) / 1e3)
            replayed = all(c for _, _, c in steps)
            runs[label] = dict(student=str(student), wall_s=wall, steps_per_s=rate,
                               losses=losses, launches=counts, replayed=replayed)
            log(f"  flags {label}: {DISTILL_STEPS} distill steps at batch {TRAIN_B}, "
                f"{rate:.3f} steps/s (steps 2-{DISTILL_STEPS} replayed, CUDA events); CLI "
                f"{wall:.1f} s; launches {counts}; step graph captured at step 1 {replayed}")
            if len(steps) != DISTILL_STEPS or not replayed:
                fail(f"distill {label}: the CLI's steps did not replay a captured graph")
    finally:
        distill.Distiller.make_step_fn = real_make
        set_train_flags(False)
    probe_steps = 60 + 30  # probe_fidelity: the teacher's 60 levels, the student's 30
    want = {"fused_attention": 27 * DISTILL_STEPS + 9 * probe_steps,
            "fused_conv_block": 18 * DISTILL_STEPS + 6 * probe_steps}
    on, off = runs["on"]["launches"], runs["off"]["launches"]
    if any(off.values()):
        fail(f"distill: kernels launched with the flags off: {off}")
    got = {k: on[k] for k in want}
    if got != want or on["fused_bottleneck"] or on["fused_encoder_layer"] or on["fused_unet_t4"]:
        fail(f"distill: launches {on}, expected {want} (27 / 18 a step, 9 / 6 a probe level)")
    log(f"  launches with the flags on: attention {got['fused_attention']} = 27 x "
        f"{DISTILL_STEPS} + 9 x {probe_steps} probe levels, conv block "
        f"{got['fused_conv_block']} = 18 x {DISTILL_STEPS} + 6 x {probe_steps}")
    a, b = np.asarray(runs["off"]["losses"]), np.asarray(runs["on"]["losses"])
    if a.shape != (DISTILL_STEPS, 3) or not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail("distill: bad loss triples")
    # At the copy the pen term can be exactly 0 on both sides: compare
    # |diff| <= 1e-4 |off| (so 0 must equal 0), and report the ratio where
    # it is defined.
    diff = np.abs(a[0] - b[0])
    nonzero = np.abs(a[0]) > 0
    first = float(np.max(diff[nonzero] / np.abs(a[0][nonzero]))) if nonzero.any() else 0.0
    log(f"  step 1 loss triples: off {a[0].tolist()}, on {b[0].tolist()}, "
        f"max relative diff {first:.3g} (over the nonzero terms)")
    if not np.all(diff <= 1e-4 * np.abs(a[0])):
        fail("distill: the first step's loss triples differ by more than 1e-4 relative")
    for c in (2, 5, 10, DISTILL_STEPS):
        log(f"  step {c}: off {a[c - 1].tolist()} | on {b[c - 1].tolist()}")
    out.update(runs=runs, first_step_rel_diff=first)

    student = Path(runs["off"]["student"])
    if DLConfig.load(student / "config.yml").training_args.distilled_steps != 30:
        fail("distill: the student's config lacks distilled_steps 30")
    seen = {}
    real_generate = inference.generate

    def spy(*args, **kw):
        seen.update(kw)
        return real_generate(*args, **kw)

    style = scribble_png(os.path.join(tmp, "distill_style.png"), 11)
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "style_trunk_synth.npz")
    inference.generate = spy
    try:
        t0 = time.perf_counter()
        strokes = inference.main([f"--prompt={INFER_PROMPT}", f"--source={style}",
                                  f"--experiment_path={student}", f"--style_weights={weights}",
                                  f"--output={tmp}/student_infer"])
        infer_s = time.perf_counter() - t0
    finally:
        inference.generate = real_generate
    picked = (seen.get("n_steps"), seen.get("schedule"), seen.get("diffusion_mode"))
    log(f"  infer on the student, no flags: n_steps {picked[0]}, schedule {picked[1]}, mode "
        f"{picked[2]}; strokes {strokes.shape}, {infer_s:.2f} s")
    if picked != (30, "halved", "ddim") or not np.isfinite(strokes).all():
        fail(f"distill: infer on the student took {picked}, expected (30, halved, ddim)")
    out["infer"] = dict(picked=list(picked), wall_s=infer_s)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        probe = probe_distill.main([f"--teacher={run}", f"--student={student}", "--multi=1"])
    probe_s = time.perf_counter() - t0
    nums = [probe["copy_vs_teacher_mse"], probe["student_vs_teacher_mse"],
            *probe["copy_per_prompt"], *probe["student_per_prompt"]]
    log(f"  probe_distill --multi=1 (f32): copy {probe['copy_vs_teacher_mse']:.4g}, student "
        f"{probe['student_vs_teacher_mse']:.4g}, won {probe['prompts_won']}, {probe_s:.1f} s")
    if probe["n_prompts"] != 8 or not np.isfinite(nums).all():
        fail(f"distill: bad probe_distill result {probe}")
    out["probe_cli"] = dict(probe, wall_s=probe_s)

    teacher_bf = DiffusionModel.load(run / "model_final", dtype=torch.bfloat16, device="cuda")
    student_bf = DiffusionModel.load(student / "model_final", dtype=torch.bfloat16,
                                     device="cuda")
    text = probe_distill.prompt_batch("", multi=True)
    reset_all_counts()
    t0 = time.perf_counter()
    probe_bf = probe_distill.probe(teacher_bf, student_bf, text, 60, 30, torch.device("cuda"))
    torch.cuda.synchronize()
    bf_s = time.perf_counter() - t0
    counts = kernel_launches()
    log(f"  the probe's 3 generate calls in bf16 at B = 8 (60 + 30 + 30 steps): launches "
        f"{counts}, copy {probe_bf['copy_vs_teacher_mse']:.4g}, student "
        f"{probe_bf['student_vs_teacher_mse']:.4g}, {bf_s:.1f} s")
    want = {"fused_bottleneck": 120, "fused_encoder_layer": 240}
    if {k: counts[k] for k in want} != want or counts["fused_unet_t4"] or not np.isfinite(
            [probe_bf["copy_vs_teacher_mse"], probe_bf["student_vs_teacher_mse"]]).all():
        fail(f"distill: bf16 probe launches {counts} (expected {want}) or non-finite output")
    out["probe_bf16"] = dict(probe_bf, launches=counts, wall_s=bf_s)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  distill phase {out['phase_s']:.1f} s")
    report["distill"] = out
    return runs["on"]["launches"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_cli(label, cfg, tmp, ranks=1, timeout=600):
    """`python -m dhg_torch.train --config=<cfg as JSON>` in `ranks`
    processes on the card (rank r gets distributed.process_id r); returns
    rank 0's run dir and metrics rows."""
    from pathlib import Path

    cfg = json.loads(json.dumps(cfg))
    cfg["experiment"]["work_dir"] = os.path.join(tmp, label)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    procs = []
    try:
        for r in range(ranks):
            if "distributed" in cfg["training_args"]:
                cfg["training_args"]["distributed"]["process_id"] = r
            path = os.path.join(tmp, f"{label}_rank{r}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dhg_torch.train", f"--config={path}"], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{label}: rank {r} exited {p.returncode}:\n{text[-3000:]}")
    runs = [m.parent for m in Path(tmp, label).rglob("metrics.jsonl")]
    if len(runs) != 1 or len(list(Path(tmp, label).rglob("run.log"))) != 1:
        fail(f"{label}: expected one run dir (rank 0's), found {runs}")
    rows = [json.loads(x) for x in (runs[0] / "metrics.jsonl").read_text().splitlines()]
    return runs[0], rows


def multiprocess_phase(tmp, report):
    """Phase 7f: the train CLI under torch.distributed, f32, batch 96, T 480,
    both train flags on, MP_STEPS steps each. (a) one process in an NCCL
    group against the run without a group: losses bit for bit. (b) two
    processes sharing the card under gloo (NCCL refuses two ranks on one
    device), data_parallel 2, then model_parallel 2: losses within 1e-4
    relative of (a)'s run without a group, one run dir. (c) the
    model-parallel run's model_final loads strictly into a one-device
    model."""
    from pathlib import Path

    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools.profile_train import best_config

    t_phase = time.perf_counter()
    out: dict = {}
    base = best_config(tmp, MP_STEPS, TRAIN_B)
    base["training_args"].update(compute_dtype="float32", log_freq=1, save_freq=1000,
                                 val_freq=MP_STEPS,
                                 mesh={"data_parallel": None, "model_parallel": 1})
    specs = (("solo", 1, {}),
             ("nccl1", 1, {"distributed": {"num_processes": 1, "backend": "nccl"}}),
             ("gloo_dp2", 2, {"distributed": {"num_processes": 2, "backend": "gloo"}}),
             ("gloo_tp2", 2, {"distributed": {"num_processes": 2, "backend": "gloo"},
                              "mesh": {"data_parallel": None, "model_parallel": 2}}))
    ports: set = set()
    while len(ports) < len(specs):  # a coordinator port each, distinct
        ports.add(free_port())

    def run_cli(spec, port):
        label, ranks, extra = spec
        cfg = json.loads(json.dumps(base))
        cfg["training_args"].update(json.loads(json.dumps(extra)))
        if "distributed" in extra:
            cfg["training_args"]["distributed"]["coordinator_address"] = f"localhost:{port}"
        t0 = time.perf_counter()
        run, rows = train_cli(label, cfg, tmp, ranks)
        return run, rows, time.perf_counter() - t0

    set_train_flags(True)
    try:
        results = {}
        # Two runs at a time on the card (each run's arithmetic is its own, so
        # the comparisons below hold; the walls are of runs sharing the card).
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for pair, pair_ports in ((specs[:2], sorted(ports)[:2]),
                                     (specs[2:], sorted(ports)[2:])):
                for (label, ranks, _), (run, rows, wall) in zip(
                        pair, pool.map(run_cli, pair, pair_ports)):
                    losses = [[r["loss"], r["score"], r["pen"]] for r in rows if "loss" in r]
                    vals = [[r["val_loss"], r["val_score"], r["val_pen"]] for r in rows
                            if "val_loss" in r]
                    results[label] = dict(run=str(run), losses=losses, val=vals, wall_s=wall)
                    log(f"  {label}: {ranks} process(es), {wall:.1f} s (beside another run), "
                        f"steps {[r['step'] for r in rows if 'loss' in r]}, losses "
                        f"{[round(l[0], 6) for l in losses]}, val {vals}")
                    if len(vals) != 1 or not np.isfinite(vals).all():
                        fail(f"multiprocess: {label} has no finite validation at step "
                             f"{MP_STEPS}")
    finally:
        set_train_flags(False)
    solo = np.asarray(results["solo"]["losses"])
    if solo.shape != (MP_STEPS, 3) or not np.isfinite(solo).all():
        fail(f"multiprocess: bad solo losses {solo.tolist()}")
    if (results["nccl1"]["losses"], results["nccl1"]["val"]) != (results["solo"]["losses"],
                                                                 results["solo"]["val"]):
        fail("multiprocess: the NCCL world-size-1 run differs from the run without a group")
    log("  (a) NCCL world size 1 == no process group, bit for bit (losses and the replayed "
        "validation)")
    for label in ("gloo_dp2", "gloo_tp2"):
        got = np.asarray(results[label]["losses"])
        rel = float(np.max(np.abs(got - solo) / np.abs(solo)))
        results[label]["max_rel_diff"] = rel
        mesh = "(2, 1)" if label == "gloo_dp2" else "(1, 2)"
        run_log = (Path(results[label]["run"]) / "run.log").read_text()
        if f"mesh (data, model) {mesh}" not in run_log:
            fail(f"multiprocess: {label}'s run.log does not show the mesh {mesh}")
        if "steps_per_call auto is 1 under the gloo process group" not in run_log:
            fail(f"multiprocess: {label}'s run.log does not say that auto is 1 under gloo")
        if "validation runs eagerly under the gloo process group" not in run_log:
            fail(f"multiprocess: {label}'s run.log does not say that validation is eager "
                 "under gloo")
        log(f"  (b) {label}: mesh {mesh}; max relative loss diff against the solo run {rel:.3g}")
        if got.shape != solo.shape or rel > 1e-4:
            fail(f"multiprocess: {label} losses differ from the solo run by {rel:.3g} relative")
    tp_final = Path(results["gloo_tp2"]["run"]) / "model_final"
    model = DiffusionModel.load(tp_final, device="cuda")  # strict load_state_dict
    n = sum(p.numel() for p in model.parameters())
    log(f"  (c) the model_parallel run's model_final loads strictly: {n:,} parameters")
    out.update(results, tp_checkpoint_params=n, phase_s=time.perf_counter() - t_phase)
    log(f"  multiprocess phase {out['phase_s']:.1f} s")
    report["multiprocess"] = out


def event_ms(fn):
    """(fn(), milliseconds) from CUDA events around one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def stroke_mse(a, b) -> float:
    return float(((a[..., :2].float() - b[..., :2].float()) ** 2).mean())


def counted_run(fn):
    """(fn(), the sampler kernels' launches during it)."""
    from dhg_torch.kernels import fused_bottleneck as fk

    fk.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, tuple(fk.launches[k] for k in SAMPLER_KERNELS)


def tool_json(main, argv):
    """A tool's main(argv): its stdout parsed as JSON (one object, or one per
    line) and what main returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    text = buf.getvalue()
    log("    " + text.strip().replace("\n", "\n    "))
    try:
        parsed = json.loads(text)
    except json.JSONDecodeError:
        parsed = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    return parsed, ret, text


def optin_phase(run, tmp, report):
    """Phase 7g: the opt-in samplers and the seven tools (see the module
    docstring)."""
    import math
    from pathlib import Path

    from dhg_torch.core.parallel_sampling import parallel_ddim_sample
    from dhg_torch.data.images import read_png
    from dhg_torch.inference import _sample, beta_table, generate
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools import (bench_hoist, eval_encoder_reuse, eval_fewer_steps,
                                 eval_parallel_sampler, plot_run, profile_stages, sweep)
    from dhg_torch.tools.profile_train import best_config

    t_phase = time.perf_counter()
    out: dict = {}
    canonical = {"channels": 128, "att_layers_num": 2}
    model = DiffusionModel.from_config(canonical, dtype=torch.bfloat16, device="cuda", seed=0)

    def sampler(mdl, text, style, seed, **kw):
        return lambda: generate(mdl, text, style, torch.Generator(device="cuda").manual_seed(seed),
                                seq_len=SEQ_LEN, device="cuda", **kw)

    def check_launches(label, got, want):
        log(f"  {label}: launches {dict(zip(SAMPLER_KERNELS, got))}")
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")

    # -- the full hoist against the compact one (bf16) ---------------------------
    hoist = {}
    for batch in (96, 256):
        _, text, style = make_inputs(batch, seed=40 + batch)
        compact, full = sampler(model, text, style, batch), sampler(model, text, style, batch,
                                                                    hoist="full")
        want = (60, 120 if batch <= 128 else 0, 0)
        peaks = {}
        for name, fn in (("compact", compact), ("full", full)):
            torch.cuda.reset_peak_memory_stats()
            res, got = counted_run(fn)
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
            check_launches(f"{name} hoist B={batch}", got, want)
            if name == "compact":
                ref = res
        equal = torch.equal(res, ref)
        diff, mse = float((res - ref).abs().max()), stroke_mse(res, ref)
        log(f"  full hoist B={batch} against compact: bit for bit {equal} (max |diff| {diff:.3g}, "
            f"stroke MSE {mse:.3g}); peak memory compact {peaks['compact']:.3f} GiB, "
            f"full {peaks['full']:.3f} GiB")
        if not equal and not mse <= 1e-3:
            fail(f"full hoist B={batch}: stroke MSE {mse} against compact")
        ms = {"compact": [], "full": []}
        compact(), full()  # the captures: every timed call below replays
        for name in ("compact", "full", "full", "compact"):
            ms[name].append(event_ms(compact if name == "compact" else full)[1])
        log(f"  B={batch} ms per 60-step call (compact, full, full, compact): "
            f"{ms['compact'][0]:.1f}, {ms['full'][0]:.1f}, {ms['full'][1]:.1f}, "
            f"{ms['compact'][1]:.1f}")
        hoist[str(batch)] = {"bit_for_bit": equal, "max_abs_diff": diff, "stroke_mse": mse,
                             "peak_gib": peaks, "ms": ms, "launches": want}
        if batch == 96:
            with env_flag("DHG_FUSED_T4", "1"):
                _, got = counted_run(full)
            check_launches("full hoist B=96, DHG_FUSED_T4=1", got, (0, 0, 60))
            hoist[str(batch)]["t4_launches"] = got
        del text, style, res, ref
        torch.cuda.empty_cache()
    out["hoist"] = hoist

    # -- encoder reuse (bf16, B = 96) ---------------------------------------------
    _, text, style = make_inputs(96, seed=50)
    exact, got = counted_run(sampler(model, text, style, 5))
    k1, got1 = counted_run(sampler(model, text, style, 5, encoder_reuse=1))
    check_launches("encoder_reuse=1 B=96", got1, (60, 120, 0))
    if not torch.equal(k1, exact):
        fail("encoder_reuse=1 differs from the compact sampler")
    # The reuse sampler itself at reuse_every = 1, on the full hoist.
    with torch.inference_mode():
        direct, gotd = counted_run(lambda: _sample(
            model, text, style, torch.Generator(device="cuda").manual_seed(5), SEQ_LEN,
            beta_table(N_STEPS, "strided", "cuda"), "new", None, 1.0, None, None,
            torch.device("cuda"), encoder_reuse=1))
    check_launches("reuse sampler, reuse_every=1, B=96", gotd, (60, 120, 0))
    d_equal, d_mse = torch.equal(direct, exact), stroke_mse(direct, exact)
    log(f"  reuse sampler at reuse_every=1 against compact: bit for bit {d_equal} "
        f"(stroke MSE {d_mse:.3g})")
    if not d_equal and not d_mse <= 1e-3:
        fail(f"reuse sampler at reuse_every=1: stroke MSE {d_mse} against compact")
    reuse = {"k1_equal": True, "direct_k1_bit_for_bit": d_equal, "direct_k1_mse": d_mse}
    fns = {k: sampler(model, text, style, 5, encoder_reuse=k) for k in (1, 2, 3)}
    for k in (2, 3):
        res, got = counted_run(fns[k])
        check_launches(f"encoder_reuse={k} B=96", got, (60, 2 * math.ceil(60 / k), 0))
        mse = stroke_mse(res, exact)
        log(f"  encoder_reuse={k}: stroke MSE {mse:.4g} against k = 1; finite "
            f"{bool(torch.isfinite(res).all())}")
        reuse[f"k{k}"] = {"launches": got, "stroke_mse_vs_k1": mse}
    with env_flag("DHG_FUSED_T4", "1"):
        _, got = counted_run(fns[2])
    check_launches("encoder_reuse=2 B=96, DHG_FUSED_T4=1 (no T4 under reuse)", got, (60, 60, 0))
    fns[2](), fns[3]()  # the captures (k = 1 is the compact key, captured above)
    order = (1, 2, 3, 3, 2, 1)
    ms = {k: [] for k in (1, 2, 3)}
    for k in order:
        ms[k].append(event_ms(fns[k])[1])
    log("  B=96 ms per call (k = 1, 2, 3, 3, 2, 1): "
        + ", ".join(f"{ms[k][i]:.1f}" for k, i in zip(order, (0, 0, 0, 1, 1, 1))))
    reuse["ms"] = {str(k): v for k, v in ms.items()}
    out["reuse"] = reuse
    del text, style, exact, k1, direct, res
    torch.cuda.empty_cache()

    # -- Jacobi parallel DDIM (B = 1) ---------------------------------------------
    model32 = DiffusionModel.from_config(canonical, device="cuda", seed=0)
    _, text, style = make_inputs(1, seed=61)
    seq, seq_ms = event_ms(sampler(model32, text, style, 7, diffusion_mode="ddim"))

    def denoise_any(x, sigma):
        reps = x.shape[0]
        return model32(x, text.repeat(reps, 1), sigma, style.repeat(reps, 1, 1))

    torch.cuda.reset_peak_memory_stats()
    (par, ests), got = counted_run(lambda: parallel_ddim_sample(
        denoise_any, 1, SEQ_LEN, sweeps=60, generator=torch.Generator(device="cuda").manual_seed(7),
        return_all_sweeps=True, device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("Jacobi DDIM f32, B=1, 60 sweeps (the gate is closed)", got, (0, 0, 0))
    mses = {k: stroke_mse(ests[k - 1], seq) for k in (4, 8, 12, 16, 30, 60)}
    _, par_ms = event_ms(lambda: parallel_ddim_sample(
        denoise_any, 1, SEQ_LEN, sweeps=60, generator=torch.Generator(device="cuda").manual_seed(7),
        device="cuda"))
    _, seq_ms = event_ms(sampler(model32, text, style, 7, diffusion_mode="ddim"))
    log(f"  Jacobi DDIM f32 B=1 T={SEQ_LEN}: stroke MSE against sequential DDIM by sweeps "
        + ", ".join(f"{k}: {v:.3g}" for k, v in mses.items())
        + f"; 60 sweeps {par_ms:.1f} ms, sequential {seq_ms:.1f} ms; peak {peak:.3f} GiB")
    if not mses[60] <= 1e-3:
        fail(f"Jacobi DDIM: 60 sweeps {mses[60]} from the sequential DDIM")
    log("  tools/eval_parallel_sampler.py at its defaults (bf16, random weights):")
    table, ret, _ = tool_json(eval_parallel_sampler.main, ["--device=cuda"])
    check_launches("eval_parallel_sampler's parallel runs", tuple(
        ret["sampler_kernel_launches"][k] for k in SAMPLER_KERNELS), (0, 0, 0))
    out["jacobi"] = {"f32_stroke_mse_by_sweeps": mses, "f32_60_sweeps_ms": par_ms,
                     "f32_sequential_ms": seq_ms, "peak_gib": peak, "launches": got,
                     "bf16_table": ret}
    del model32, par, ests, seq
    torch.cuda.empty_cache()

    # -- training's profile_dir ---------------------------------------------------
    cfg = best_config(tmp, 4, TRAIN_B)
    trace_dir = os.path.join(tmp, "profile_trace")
    cfg["training_args"].update(profile_dir=trace_dir, profile_start=2, profile_steps=1,
                                log_freq=2, save_freq=100)
    set_train_flags(True)
    t0 = time.perf_counter()
    prof_run, _ = train_cli("profile", cfg, tmp)
    set_train_flags(False)
    traces = sorted(Path(trace_dir).iterdir())
    if [p.name for p in traces] != ["train_steps_2-3.json"]:
        fail(f"profile_dir: expected train_steps_2-3.json, found {[p.name for p in traces]}")
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    spans = sorted(n for n in names if n.startswith("train_step "))
    kernels = {k: any(k in n for n in names) for k in ("attention_mma_kernel", "conv_block_kernel")}
    logged = "Profiler trace written to" in (prof_run / "run.log").read_text()
    log(f"  profile_dir: {traces[0].name} ({traces[0].stat().st_size / 2**20:.1f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s; spans {spans}; kernels named {kernels}; "
        f"run.log line {logged}")
    if spans != ["train_step 2", "train_step 3"] or not all(kernels.values()) or not logged:
        fail("profile_dir: the trace does not hold steps 2-3 with both train kernels")
    out["profile_dir"] = {"trace_mib": traces[0].stat().st_size / 2**20, "spans": spans,
                          "kernels": kernels}

    # -- the tools at small arguments ---------------------------------------------
    tools = {}
    log("  tools/eval_fewer_steps.py on the train run (f32):")
    rep, ret, _ = tool_json(eval_fewer_steps.main, ["--device=cuda", f"--experiment_path={run}",
                                                    "--batch=8", "--steps=30,15",
                                                    "--diffusion_mode=ddim"])
    if rep != ret or set(rep) != TOOL_KEYS["eval_fewer_steps"] or any(
            set(r) != TOOL_KEYS["eval_fewer_steps_row"] for r in rep["rows"]):
        fail("eval_fewer_steps: bad report")
    tools["eval_fewer_steps"] = rep
    log("  tools/eval_encoder_reuse.py on the train run (f32):")
    rep, ret, _ = tool_json(eval_encoder_reuse.main, ["--device=cuda", f"--experiment_path={run}",
                                                      "--batch=8", "--reuse=2,3"])
    if rep != ret or set(rep) != TOOL_KEYS["eval_encoder_reuse"] or any(
            set(r) != TOOL_KEYS["eval_encoder_reuse_row"] for r in rep["rows"]):
        fail("eval_encoder_reuse: bad report")
    tools["eval_encoder_reuse"] = rep
    log("  tools/sweep.py:")
    rows, ret, _ = tool_json(sweep.main, ["--device=cuda", "--batches=96", "--steps=20,60"])
    if rows != ret or len(rows) != 2 or any(set(r) != TOOL_KEYS["sweep"] for r in rows):
        fail("sweep: bad rows")
    tools["sweep"] = rows
    log("  tools/bench_hoist.py:")
    rows, ret, text_out = tool_json(bench_hoist.main, ["--device=cuda", "--batches=96"])
    if rows != ret or len(rows) != 2 or any(set(r) != TOOL_KEYS["bench_hoist"] for r in rows) \
            or "BEST: {" not in text_out:
        fail("bench_hoist: bad rows")
    tools["bench_hoist"] = rows
    log("  tools/profile_stages.py:")
    rep, ret, _ = tool_json(profile_stages.main, ["--device=cuda", "--batch=96"])
    layer = {"fused_encoder_layer": 1}
    want_kernels = {"full": {"fused_bottleneck": 1, "fused_encoder_layer": 2}, "enc1": {},
                    "enc2_enc3": layer, "enc4_enc5": layer, "att_stack": {"fused_bottleneck": 1},
                    "decoder": {}}
    if rep != ret or set(rep) != TOOL_KEYS["profile_stages"] or rep["kernels"] != want_kernels:
        fail(f"profile_stages: bad report (kernels {rep.get('kernels')}, want {want_kernels})")
    tools["profile_stages"] = rep
    png = os.path.join(tmp, "loss_curves.png")
    _, ret, _ = tool_json(plot_run.main, ["--experiment_path", str(prof_run), "--output", png])
    shape = read_png(png).shape
    log(f"  tools/plot_run.py on the profile run: {png} {shape}")
    if shape != (600, 1080, 3):
        fail("plot_run: bad PNG")
    out["tools"] = tools
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  opt-in samplers and tools phase {out['phase_s']:.1f} s")
    report["optin"] = out


def style_phase(iam, tmp, report):
    """Phase 7h: the random trunk's scale, the style-trunk trainer and the
    three style tools on phase 7d's tree, cache and run (see the module
    docstring)."""
    import contextlib
    import io
    from pathlib import Path

    from dhg_torch.tools import eval_fsd_sensitivity as fsd
    from dhg_torch.tools import eval_style_gap as gap
    from dhg_torch.tools import eval_style_pathway as pathway
    from dhg_torch.tools import train_style_trunk as tst

    t_phase = time.perf_counter()
    reset_all_counts()
    out: dict = {}

    def quiet(fn, *args, **kw):
        with contextlib.redirect_stdout(io.StringIO()) as said:
            result = fn(*args, **kw)
        return result, said.getvalue()

    def check_keys(label, got, want):
        if set(got) != want:
            fail(f"{label}: report keys {sorted(got)}, expected {sorted(want)}")

    # -- the random trunk's scale (flax's init) -------------------------------------
    t0 = time.perf_counter()
    imgs, labels = gap.benchmark_lines(gap.BENCHMARK_WRITERS, gap.BENCHMARK_LINES,
                                       gap.BENCHMARK_WIDTH)
    vecs = gap.style_vectors(gap.quiet_extractor(device="cuda"), imgs)
    out["random_trunk"] = {"feature_std": float(vecs.std()),
                           "feature_std_per_dim_mean": float(vecs.std(axis=0).mean()),
                           "wall_s": time.perf_counter() - t0}
    log(f"  random trunk (flax's init, seed 0): feature std {vecs.std():.4g} over "
        f"{len(imgs)} benchmark lines (a torch-default init gave ~1e-8)")
    if not 1e-4 < vecs.std() < 1.0 or not np.isfinite(vecs).all():
        fail(f"style: the random trunk's features are off scale (std {vecs.std():.3g})")

    # -- train_style_trunk at dhg's defaults, then evaluate ------------------------
    stats: dict = {}
    trunk = str(Path(tmp) / "style_trunk_synth.npz")
    res, said = quiet(tst.train, out=trunk, device="cuda", stats=stats, **STYLE_TRUNK)
    log("    " + "\n    ".join(said.strip().splitlines()[-4:]))
    check_keys("train_style_trunk", res, STYLE_KEYS["train_style_trunk"])
    t0 = time.perf_counter()
    trained = tst.evaluate(trunk, "cuda")
    random_ret = tst.evaluate(None, "cuda")
    eval_s = time.perf_counter() - t0
    log(f"  train_style_trunk {STYLE_TRUNK}: set built in {stats['build_s']:.1f} s, "
        f"{stats['steps_per_sec']:.2f} steps/s ({stats['train_s']:.1f} s), final ce "
        f"{res['final_ce']:.4f}, batch acc {res['final_acc']:.3f}")
    log(f"  evaluate (8 x 6 benchmark): trained {trained}; random {random_ret} "
        f"({eval_s:.1f} s for both)")
    if not np.isfinite(res["final_ce"]) or set(trained) != RETRIEVAL_KEYS:
        fail("train_style_trunk: bad result")
    out["train_style_trunk"] = dict(res, **stats, trained=trained, random=random_ret,
                                    evaluate_s=eval_s, config=STYLE_TRUNK)

    # -- tree mode on phase 7d's tree -----------------------------------------------
    tree_stats: dict = {}
    tree_res, said = quiet(tst.train, out=str(Path(tmp) / "style_trunk_tree.npz"),
                           tree=str(iam["tree"]), device="cuda", stats=tree_stats, **STYLE_TREE)
    check_keys("train_style_trunk --tree", tree_res,
               STYLE_KEYS["train_style_trunk"] | {"holdout_retrieval"})
    log(f"  tree mode {STYLE_TREE}: set built in {tree_stats['build_s']:.1f} s, "
        f"{tree_stats['steps_per_sec']:.2f} steps/s, final ce {tree_res['final_ce']:.4f}, "
        f"held-out forms {tree_res['holdout_retrieval']}")
    out["tree_mode"] = dict(tree_res, **tree_stats, config=STYLE_TREE)

    # -- eval_style_gap (8 x 6; the ablation on phase 7d's run) ----------------------
    t0 = time.perf_counter()
    gap_rep, _ = quiet(gap.main, ["--device=cuda", f"--experiment_path={iam['run']}"])
    disc, abl = gap_rep["discrimination"], gap_rep["ablation"]
    check_keys("eval_style_gap", disc, STYLE_KEYS["eval_style_gap"])
    check_keys("eval_style_gap ablation", abl, STYLE_KEYS["eval_style_gap_ablation"])
    pixels = disc["pixel_baseline"]["top1_retrieval"]
    log(f"  eval_style_gap: random trunk {disc['top1_retrieval']}, pixels {pixels}, chance "
        f"{disc['chance']}; ablation {abl} ({time.perf_counter() - t0:.1f} s)")
    out["eval_style_gap"] = dict(gap_rep, wall_s=time.perf_counter() - t0)
    if not trained["top1_retrieval"] > pixels:
        fail(f"style: the trained trunk retrieves {trained['top1_retrieval']}, not above the "
             f"raw-pixel baseline's {pixels}")

    # -- eval_fsd_sensitivity on phase 7d's train cache ------------------------------
    t0 = time.perf_counter()
    n = min(48, iam["rows"] // 2)
    fsd_rep, _ = quiet(fsd.main, ["--device=cuda", f"--cache={iam['cache']}",
                                  f"--weights={trunk}", f"--n={n}"])
    check_keys("eval_fsd_sensitivity", fsd_rep, STYLE_KEYS["eval_fsd_sensitivity"])
    for name in ("random_init", "trained"):
        check_keys(f"eval_fsd_sensitivity {name}", fsd_rep[name],
                   STYLE_KEYS["eval_fsd_sensitivity_trunk"])
        if not all(np.isfinite(v) for v in fsd_rep[name]["fsd"].values()):
            fail(f"eval_fsd_sensitivity: non-finite FSD ({name})")
        log(f"  FSD {name} (n {n}): {fsd_rep[name]}")
    log(f"  (dhg's record, random trunk, rasterised pages: feature std 9.3e-5); "
        f"{time.perf_counter() - t0:.1f} s")
    out["eval_fsd_sensitivity"] = dict(fsd_rep, wall_s=time.perf_counter() - t0)

    # -- eval_style_pathway on phase 7d's run -----------------------------------------
    t0 = time.perf_counter()
    path_rep, _ = quiet(pathway.main, ["--device=cuda", f"--experiment_path={iam['run']}"])
    check_keys("eval_style_pathway", path_rep, STYLE_KEYS["eval_style_pathway"])
    log(f"  eval_style_pathway: {path_rep['output_swap']}; {path_rep['val_loss_by_style']} "
        f"({time.perf_counter() - t0:.1f} s)")
    out["eval_style_pathway"] = dict(path_rep, wall_s=time.perf_counter() - t0)

    torch.cuda.synchronize()
    launches = kernel_launches()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches over the phase {launches}; style phase {out['phase_s']:.1f} s")
    report["style"] = out
    if any(launches.values()):
        fail(f"style: kernels launched ({launches}); none is on this path")
    if out["phase_s"] > STYLE_PHASE_S:
        fail(f"style: the phase took {out['phase_s']:.1f} s (limit {STYLE_PHASE_S:.0f} s)")


def torchvision_trunk(seed: int) -> torch.nn.Module:
    """torchvision's mobilenet_v2().features rebuilt with its child names
    (state_dict keys `features.N...`), in eval mode: torch's init under
    `seed`, each BatchNorm's weight, bias and running statistics drawn from
    a numpy RandomState(seed) as U(0.5, 1.5), N(0, 0.1), N(0, 0.2) and
    U(0.3, 1.3)."""
    from torch import nn

    from dhg_torch.models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS

    def conv_bn(cin, cout, k, stride=1, groups=1):
        return nn.Sequential(nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                                       bias=False), nn.BatchNorm2d(cout), nn.ReLU6(inplace=True))

    class InvertedResidual(nn.Module):
        def __init__(self, cin, cout, stride, expand):
            super().__init__()
            hidden = cin * expand
            self.use_res = stride == 1 and cin == cout
            layers = [conv_bn(cin, hidden, 1)] if expand != 1 else []
            self.conv = nn.Sequential(*layers, conv_bn(hidden, hidden, 3, stride, hidden),
                                      nn.Conv2d(hidden, cout, 1, bias=False),
                                      nn.BatchNorm2d(cout))

        def forward(self, x):
            return x + self.conv(x) if self.use_res else self.conv(x)

    class Features(nn.Module):
        def __init__(self):
            super().__init__()
            feats, cin = [conv_bn(3, 32, 3, 2)], 32
            for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
                for i in range(n):
                    feats.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                    cin = c
            self.features = nn.Sequential(*feats, conv_bn(cin, 1280, 1))

        def forward(self, x):
            return self.features(x)

    rng = np.random.RandomState(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = Features().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5))
                m.bias.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1))
                m.running_mean.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.2))
                m.running_var.copy_(torch.from_numpy(rng.rand(n).astype(np.float32) + 0.3))
    return net


def converters_phase(run, tmp, style_png, infer_strokes, report):
    """Phase 7i: the three converter CLIs on phase 7's run dir, phase 7b's
    infer call and a torchvision-layout trunk (see the module docstring)."""
    import contextlib
    import io
    from pathlib import Path

    from dhg_torch.checkpoint import load_checkpoint
    from dhg_torch.inference import main as infer_main
    from dhg_torch.models.style_extractor import init_style_extractor
    from dhg_torch.tools import convert_torch_checkpoint as ckpt_convert
    from dhg_torch.tools import convert_torchvision_mnv2 as mnv2
    from dhg_torch.tools import export_torch_checkpoint as export

    t_phase = time.perf_counter()
    set_train_flags(False)
    reset_all_counts()
    tmp, out = Path(tmp), {}

    def said(main, argv):
        with contextlib.redirect_stdout(io.StringIO()) as text:
            result = main(argv)
        log("    " + text.getvalue().strip())
        return result

    # -- (a) export model_final: the EMA weights in the reference's container ----------
    t0 = time.perf_counter()
    exported = tmp / "export.pth"
    said(export.main, [f"--experiment_path={run}", f"--dst={exported}"])
    saved = torch.load(exported, map_location="cpu", weights_only=True)
    ema = load_checkpoint(Path(run) / "model_final")["ema_state_dict"]
    sd = saved["state_dict"]
    same = sorted(sd) == sorted(ema) and all(torch.equal(sd[k], ema[k]) for k in ema)
    if list(saved) != ["meta", "state_dict"] or saved["meta"].get("ema") is not True or not same:
        fail(f"export: keys {list(saved)}, meta {saved.get('meta')}, EMA weights equal: {same}")

    # -- (b) bare state_dict with DDP's prefixes, converted back -----------------------
    bare, converted = tmp / "bare_module.pth", tmp / "converted"
    torch.save({f"module.{k}": v for k, v in sd.items()}, bare)
    said(ckpt_convert.main, [f"--src={bare}", f"--dst={converted}"])
    back = load_checkpoint(converted)["state_dict"]
    if list(back) != list(sd) or not all(torch.equal(back[k], sd[k]) for k in sd):
        fail("convert_torch_checkpoint: the weights differ from the exported ones")
    out["checkpoints_s"] = time.perf_counter() - t0
    log(f"  export -> bare module. -> convert: {len(sd)} tensors equal bit for bit "
        f"({out['checkpoints_s']:.2f} s)")

    # -- (c) infer on the converted file: phase 7b's strokes ------------------------------
    t0 = time.perf_counter()
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "style_trunk_synth.npz")
    strokes = infer_main([f"--prompt={INFER_PROMPT}", f"--source={style_png}",
                          f"--checkpoint_path={converted}",
                          f"--config_path={Path(run) / 'config.yml'}",
                          f"--style_weights={weights}", f"--output={tmp / 'infer_converted'}",
                          "--format=png"])
    torch.cuda.synchronize()
    out["infer_s"] = time.perf_counter() - t0
    equal = strokes.shape == infer_strokes.shape and np.array_equal(strokes, infer_strokes)
    out["infer_equal"] = bool(equal)
    if strokes.shape == infer_strokes.shape:
        out["infer_stroke_mse"] = float(((strokes[:, :2] - infer_strokes[:, :2]) ** 2).mean())
    log(f"  infer on the converted file: strokes {strokes.shape}, "
        f"{'equal bit for bit to' if equal else 'DIFFERENT from'} phase 7b's "
        f"({out['infer_s']:.2f} s)")
    if not equal:
        fail(f"infer on the converted checkpoint: strokes {strokes.shape} differ from phase "
             f"7b's {infer_strokes.shape} (stroke MSE {out.get('infer_stroke_mse')})")

    # -- (d) torchvision-layout MobileNetV2 -> .npz -> init_style_extractor -------------------
    t0 = time.perf_counter()
    net = torchvision_trunk(2)
    torch.save(net.state_dict(), tmp / "mnv2.pth")
    said(mnv2.main, [f"--src={tmp / 'mnv2.pth'}", f"--dst={tmp / 'mnv2_tv.npz'}"])
    extractor = init_style_extractor(weights_path=tmp / "mnv2_tv.npz", strict=True, device="cuda")
    img = torch.from_numpy((np.random.RandomState(2).rand(2, 96, 200) * 255).astype(np.float32))
    net = net.cuda()
    with torch.no_grad():
        ours = extractor(img.cuda()).cpu().numpy()
        x = (img[:, None].cuda() / 127.5 - 1).repeat(1, 3, 1, 1)
        x = torch.nn.AdaptiveAvgPool2d((1, 14))(torch.nn.AvgPool2d(3, 3)(net(x)))
        want = x.squeeze(2).permute(0, 2, 1).cpu().numpy()
    err = np.abs(ours - want)
    out["mnv2"] = {"shape": list(ours.shape), "max_abs_err": float(err.max()),
                   "max_excess": float((err - (1e-4 + 1e-3 * np.abs(want))).max()),
                   "wall_s": time.perf_counter() - t0}
    log(f"  convert_torchvision_mnv2 -> init_style_extractor on the card: {ours.shape}, max |diff| "
        f"{err.max():.3g} against the trunk (bar rtol 1e-3, atol 1e-4; "
        f"{out['mnv2']['wall_s']:.2f} s)")
    if ours.shape != (2, 14, 1280) or out["mnv2"]["max_excess"] > 0:
        fail("convert_torchvision_mnv2: the converted trunk's vectors are off the torchvision "
             "trunk's")

    torch.cuda.synchronize()
    launches = kernel_launches()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches over the phase {launches}; converters phase {out['phase_s']:.1f} s")
    report["converters"] = out
    if any(launches.values()):
        fail(f"converters: kernels launched ({launches}); none is on this path")
    if out["phase_s"] > CONVERT_PHASE_S:
        fail(f"converters: the phase took {out['phase_s']:.1f} s (limit {CONVERT_PHASE_S:.0f} s)")


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


def chunk_case(cfg, label, timed: bool) -> dict:
    """Phase 8b's case: an eager trainer (train_step, steps 1-20) and a
    chunked one (train_chunk: 16 steps, then 4) from one init and seed, each
    with an `evaluate` before the steps, after 16 and after 20. Fatal unless
    the two agree bit for bit (params, EMA, Adam moments, the [20, 3] rows,
    the evaluations) and launch the train kernels alike. With `timed`, the
    rates in turns (eager, chunk, chunk, eager; CUDA events over 16 steps
    after the first 20) and one profiled chunk of 16 beside 4 eager steps."""
    from dhg_torch.eval import evaluate, make_eval_fn
    from dhg_torch.tools.profile_sampler import profile_call
    from dhg_torch.train import Trainer, load_cache

    val = load_cache(cfg, "validation", "cuda")
    bs = min(TRAIN_B, len(val))
    runs, trainers = {}, {}
    for mode in ("eager", "graph"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = trainers[mode] = Trainer(cfg, device="cuda")
        step = make_eval_fn(t.model)  # one a trainer, as train() holds one a run
        evals, rows, launches = [evaluate(t.model, val, bs, 0, eval_step=step)], [], {}
        t0 = time.perf_counter()
        for first, k in ((1, 16), (17, 4)):
            reset_all_counts()
            if mode == "eager":
                rows += [t.train_step(t.draw(c))[None] for c in range(first, first + k)]
            else:
                rows.append(t.train_chunk(first, k))
            torch.cuda.synchronize()
            for name, n in kernel_launches().items():
                launches[name] = launches.get(name, 0) + n
            evals.append(evaluate(t.model, val, bs, 0, eval_step=step))
        del step
        runs[mode] = dict(rows=torch.cat(rows), evals=evals, launches=launches,
                          wall_s=time.perf_counter() - t0,
                          peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
    eager, graph = trainers["eager"], trainers["graph"]
    if graph.graph is None:
        fail(f"chunks {label}: no step graph was captured")

    def state(t):
        o = t.opt
        return [(f"{group} {name}", x) for group, xs in (
            ("param", [p.detach() for p in o.params]), ("ema", t.ema or []), ("mu", o.mu),
            ("nu", o.nu)) for name, x in zip(o.names, xs)]

    differ = [name for (name, a), (_, b) in zip(state(graph), state(eager))
              if not torch.equal(a, b)]
    same = {
        "rows": runs["graph"]["rows"].shape == (TRAIN_STEPS, 3)
        and torch.equal(runs["graph"]["rows"], runs["eager"]["rows"]),
        "state": not differ,
        "evals": all(np.array_equal(a, b) for a, b in zip(runs["graph"]["evals"],
                                                          runs["eager"]["evals"])),
        "launches": runs["graph"]["launches"] == runs["eager"]["launches"],
    }
    got = runs["graph"]["launches"]
    # With the flags, 9 attention and 6 conv-block launches a step; a live
    # dropout closes the conv block's gate (dhg's), so none of those.
    flags = os.environ.get("DHG_FUSED_ATTENTION") == "1"
    convs = 0 if cfg.training_args.dropout else 6
    want = (9 * TRAIN_STEPS, convs * TRAIN_STEPS) if flags else (0, 0)
    counted = (got.get("fused_attention", 0), got.get("fused_conv_block", 0))
    out = {"capture_s": graph.graph.body.capture_s, "replay_launches": graph.graph.body.launches,
           "launches": got, **{f"{m}_{k}": runs[m][k] for m in runs
                               for k in ("wall_s", "peak_gib")},
           "evals": [list(map(float, e)) for e in runs["graph"]["evals"]]}
    log(f"  {label}: 20 steps eager {runs['eager']['wall_s']:.2f} s, chunks 16 + 4 "
        f"{runs['graph']['wall_s']:.2f} s (capture {out['capture_s']:.2f} s); peak above the "
        f"trainer's start {runs['eager']['peak_gib']:.2f} / {runs['graph']['peak_gib']:.2f} GiB; "
        f"equal bit for bit: {same}; launches {counted} (want {want}); "
        f"val losses {[round(e[0], 6) for e in out['evals']]}")
    if not all(same.values()):
        fail(f"chunks {label}: the replayed chunk differs from the eager steps: {same}; "
             f"{len(differ)} state tensors differ, first {differ[:6]}")
    if counted != want or sum(got.values()) != sum(counted):
        fail(f"chunks {label}: launches {got}, expected {want}")
    if not timed:
        return out
    count = {"eager": TRAIN_STEPS, "graph": TRAIN_STEPS}

    def sixteen(mode):
        t, c = trainers[mode], count[mode]
        count[mode] += 16
        if mode == "graph":
            return lambda: t.train_chunk(c + 1, 16)
        return lambda: [t.train_step(t.draw(i)) for i in range(c + 1, c + 17)]

    rates = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        _, ms = event_ms(sixteen(mode))
        rates[mode].append(16 / (ms / 1e3))
    prof = {"graph": profile_call(sixteen("graph"))}
    c = count["eager"]
    prof["eager"] = profile_call(lambda: [eager.train_step(eager.draw(i))
                                          for i in range(c + 1, c + 5)])
    for mode, r in prof.items():
        log(f"  {label} {mode}: {', '.join(f'{v:.3f}' for v in rates[mode])} steps/s; "
            f"profiled {16 if mode == 'graph' else 4} steps: wall {r['wall_ms']:.1f} ms, "
            f"device {r['device_ms']:.1f} ms, idle share {r['idle_share']:.3f}, "
            f"{r['n_kernel_launches']} kernels; top "
            f"{[(k['kernel'][:40], round(k['device_ms'], 2)) for k in r['top'][:3]]}")
    out.update(rates=rates, profile=prof)
    return out


def dead_graph_case(cfg) -> dict:
    """Phase 8b's last case: a captured CUDA graph left in a dead reference
    cycle, freed only by a garbage collection (as a stopped server's graphs
    are: its handler class refers to it), then a 2-step chunk whose step
    runs gc.collect() while it is being captured. StepGraph's capture
    collects the garbage first and holds the collector off until it ends;
    a graph destroyed inside another's capture would invalidate it. Fatal
    unless the chunk is captured, its rows are finite and the collector was
    on for the eager warm-up step and off in the capture."""
    import gc

    from dhg_torch.train import Trainer

    class Cycle:
        def __init__(self, graph):
            self.graph, self.me = graph, self

    x = torch.ones(1024, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x * 2
    torch.cuda.current_stream().wait_stream(side)
    dead = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead):
        x * 2
    Cycle(dead)
    del dead
    t = Trainer(cfg, device="cuda")
    step, seen = t._step, []

    def collecting_step(d):
        seen.append(gc.isenabled())
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return step(d)

    t._step = collecting_step
    rows = t.train_chunk(1, 2)
    torch.cuda.synchronize()
    ok = t.graph is not None and seen == [True, False] and bool(torch.isfinite(rows).all())
    log(f"  a dead graph in a reference cycle, gc.collect() inside the capture: chunk "
        f"captured {t.graph is not None}, collector on in warm-up / capture {seen}, rows "
        f"finite {bool(torch.isfinite(rows).all())}")
    if not ok:
        fail(f"chunks: the step capture beside a dead graph failed (collector {seen})")
    return {"collector_warm_up_capture": seen, "capture_s": t.graph.body.capture_s}


def chunk_phase(report):
    """Phase 8b: training_args.steps_per_call on the card (see the module
    docstring)."""
    from dhg_torch.config import DLConfig
    from dhg_torch.tools.profile_train import best_config

    t_phase = time.perf_counter()
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for label in ("plain", "kernels"):
                set_train_flags(label == "kernels")
                out[label] = chunk_case(DLConfig(best_config(tmp, 0, TRAIN_B)), label, True)
            cfg = best_config(tmp, 0, TRAIN_B)
            cfg["training_args"].update(channels=32, dropout=0.1)
            set_train_flags(True)
            out["dropout"] = chunk_case(DLConfig(cfg), "dropout 0.1, channels 32", False)
            cfg["training_args"].update(dropout=0.0)
            out["dead_graph"] = dead_graph_case(DLConfig(cfg))
    finally:
        set_train_flags(False)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  chunk phase {out['phase_s']:.1f} s")
    report["chunks"] = out
    report["train_steps_per_sec_batch96_replayed"] = {
        label: statistics.mean(out[label]["rates"]["graph"]) for label in ("plain", "kernels")}


def same_forward_case(label: str, c: int = 7) -> dict:
    """Phase 8c's check: one trainer at profile's config, its forward-only
    graph captured (forward_chunk on step c + 1's draws) and replayed on
    step c's, then train_chunk(c, 1) from the same params. Fatal unless the
    replayed forward's [3] losses are within 1e-6 relative of the step's."""
    from dhg_torch.config import DLConfig
    from dhg_torch.tools.profile_train import profile_config
    from dhg_torch.train import Trainer

    t = Trainer(DLConfig(profile_config(TRAIN_B)), device="cuda")
    try:
        t.forward_chunk(c + 1, 1)  # the eager warm-up, then the capture
        fwd = t.forward_chunk(c, 1)[0]  # a replay
        row = t.train_chunk(c, 1)[0]
        torch.cuda.synchronize()
        replayed = t.forward_graph.body.graph is not None
    finally:
        t.graph = t.forward_graph = None
    err = float((fwd - row).abs().max())
    rel = err / float(row.abs().max())
    log(f"  {label}: the replayed forward on step {c}'s draws {fwd.tolist()} against "
        f"train_chunk's row {row.tolist()}: max |diff| {err:.3g} ({rel:.3g} relative)")
    if not replayed or not rel <= 1e-6:
        fail(f"profile {label}: the forward-only graph's losses differ from the step's "
             f"({rel:.3g} relative)")
    return {"forward": fwd.tolist(), "step": row.tolist(), "max_abs_diff": err, "rel": rel}


def profile_phase(report):
    """Phase 8c: dhg's train-step profile (see the module docstring)."""
    import contextlib
    import io
    from pathlib import Path

    from dhg_torch.tools import profile_train as pt

    t_phase = time.perf_counter()
    steps = -(-PROFILE_WINDOW // pt.CHUNK) * pt.CHUNK
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for label in ("plain", "kernels"):
                kernels = label == "kernels"
                set_train_flags(kernels)
                trace = os.path.join(tmp, "trace") if kernels else None
                reset_all_counts()
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    r = pt.profile(steps_per_window=PROFILE_WINDOW, trace_dir=trace)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {k: v for k, v in kernel_launches().items() if v}
                text = buf.getvalue()
                log("    " + text.strip())
                # 5 train windows (2 warm-up, 3 timed) and the trace's; 4 forward windows.
                n = steps * (5 + bool(trace) + 4)
                want = {"fused_attention": 9 * n, "fused_conv_block": 6 * n} if kernels else {}
                mfu = r["mfu_vs_h100_bf16_peak"]
                checks = {
                    "one JSON line": text.count("\n") == 1 and json.loads(text) == r,
                    "keys": set(r) == PROFILE_KEYS,
                    "0 < fwd_only_ms < ms_per_step": 0 < r["fwd_only_ms"] < r["ms_per_step"],
                    "bwd_plus_update_ms > 0": r["bwd_plus_update_ms"] > 0,
                    "MFU in (0, 1]": 0 < mfu <= 1,
                    "HBM fields null": r["hbm_bytes_per_step"] is r["hbm_bw_gbps"]
                    is r["hbm_bw_util"] is None,
                    "launches": got == want,
                    "backend": (r["backend"], r["batch"]) == ("cuda", TRAIN_B),
                }
                if trace:
                    traces = sorted(Path(trace).iterdir())
                    names = {e.get("name", "") for p in traces
                             for e in json.loads(p.read_text())["traceEvents"]}
                    named = {k: any(k in nm for nm in names)
                             for k in ("attention_mma_kernel", "conv_block_kernel")}
                    checks["trace names both kernels"] = len(traces) == 1 and all(named.values())
                    r = dict(r, trace_files=[p.name for p in traces], trace_kernels=named,
                             trace_mib=sum(p.stat().st_size for p in traces) / 2**20)
                log(f"  {label}: {wall:.1f} s; launches {got} (want {want}); "
                    f"trace {r.get('trace_mib', 0):.1f} MiB; {checks}")
                if not all(checks.values()):
                    fail(f"profile {label}: failed {[k for k, v in checks.items() if not v]}")
                out[label] = dict(r, launches=got, wall_s=wall)
                torch.cuda.empty_cache()
        if out["plain"]["flops_per_step"] != out["kernels"]["flops_per_step"]:
            fail(f"profile: flops_per_step {out['plain']['flops_per_step']} with the flags off, "
                 f"{out['kernels']['flops_per_step']} with them on")
        for label in ("plain", "kernels"):
            set_train_flags(label == "kernels")
            out[f"same_forward_{label}"] = same_forward_case(label)
            torch.cuda.empty_cache()
    finally:
        set_train_flags(False)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  profile phase {out['phase_s']:.1f} s")
    report["profile"] = out
    if out["phase_s"] > PROFILE_PHASE_S:
        fail(f"profile: the phase took {out['phase_s']:.1f} s (limit {PROFILE_PHASE_S:.0f} s)")


def distill_graph_case(ds, data, label, timed: bool, profiled: bool) -> dict:
    """Phase 8d's distill case on two Distillers of one teacher ({"eager":
    ..., "graph": ...}), each from a fresh student (init_state): eager
    `step` against make_step_fn's step (the first step eager, then the
    captured graph replayed) on the same GRAPH_DISTILL_STEPS draws. Fatal
    unless student params, Adam moments and the rows are equal bit for bit
    and the train kernels launch alike (27 attention and 18 conv-block
    launches a step with the flags, none without). With `timed`, steps/s in
    turns (eager, graph, graph, eager; CUDA events over GRAPH_TIMED_STEPS
    steps); with `profiled`, a profiled window of GRAPH_PROFILED_STEPS
    replayed steps beside 4 eager ones."""
    from dhg_torch.tools.profile_sampler import profile_call

    t_case = time.perf_counter()
    runs, steps = {}, {}
    draws = [ds["eager"].draw(torch.Generator("cuda").manual_seed(c), data.size,
                              data.strokes.shape[1]) for c in range(GRAPH_DISTILL_STEPS)]
    for mode in ("eager", "graph"):
        d = ds[mode]
        d.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if mode == "eager":
            steps[mode] = lambda x, d=d: d.step(data.arrays, x)
        else:
            steps[mode] = d.make_step_fn(data)
        reset_all_counts()
        t0 = time.perf_counter()
        rows = torch.stack([steps[mode](x) for x in draws])
        torch.cuda.synchronize()
        runs[mode] = dict(rows=rows, launches={k: v for k, v in kernel_launches().items() if v},
                          wall_s=time.perf_counter() - t0,
                          peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
    eager, graph = ds["eager"], ds["graph"]
    if graph.graph is None or graph.graph.graph is None:
        fail(f"distill graph {label}: no step graph was captured")
    differ = [f"{group} {name}" for group, a, b in (
        ("param", eager.opt.params, graph.opt.params), ("mu", eager.opt.mu, graph.opt.mu),
        ("nu", eager.opt.nu, graph.opt.nu)) for name, x, y in zip(eager.opt.names, a, b)
        if not torch.equal(x, y)]
    n = GRAPH_DISTILL_STEPS
    flags = os.environ.get("DHG_FUSED_ATTENTION") == "1"
    want = {"fused_attention": 27 * n, "fused_conv_block": 18 * n} if flags else {}
    same = {"rows": runs["graph"]["rows"].shape == (n, 3)
            and torch.equal(runs["graph"]["rows"], runs["eager"]["rows"]),
            "state": not differ,
            "launches": runs["graph"]["launches"] == runs["eager"]["launches"] == want}
    out = {"capture_s": graph.graph.capture_s, "replay_launches": graph.graph.launches,
           "launches": runs["graph"]["launches"], "equal": same,
           **{f"{m}_{k}": runs[m][k] for m in runs for k in ("wall_s", "peak_gib")}}
    log(f"  {label}: {n} steps eager {runs['eager']['wall_s']:.2f} s, first eager then replayed "
        f"{runs['graph']['wall_s']:.2f} s (capture {out['capture_s']:.2f} s); peak above the "
        f"distiller's start {runs['eager']['peak_gib']:.3f} / {runs['graph']['peak_gib']:.3f} "
        f"GiB; equal bit for bit {same}; launches {runs['graph']['launches']} (want {want})")
    if not all(same.values()):
        fail(f"distill graph {label}: the replayed steps differ from the eager ones: {same}; "
             f"{len(differ)} state tensors differ, first {differ[:6]}")
    if timed:
        k = GRAPH_TIMED_STEPS
        rates = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            _, ms = event_ms(lambda: [steps[mode](x) for x in draws[:k]])
            rates[mode].append(k / (ms / 1e3))
        out["rates"] = rates
        log(f"  {label}: steps/s eager {', '.join(f'{v:.3f}' for v in rates['eager'])}, "
            f"replayed {', '.join(f'{v:.3f}' for v in rates['graph'])}")
    if profiled:
        n_prof = {"graph": GRAPH_PROFILED_STEPS, "eager": 4}
        prof = {m: profile_call(lambda m=m: [steps[m](x) for x in draws[:n_prof[m]]])
                for m in ("graph", "eager")}
        for mode, r in prof.items():
            log(f"  {label} {mode}: profiled {n_prof[mode]} steps: wall {r['wall_ms']:.1f} ms, "
                f"device {r['device_ms']:.1f} ms, idle share {r['idle_share']:.3f}, "
                f"{r['n_kernel_launches']} kernels")
        out["profile"] = prof
    ds["graph"].graph = None  # its pool back
    out["case_s"] = time.perf_counter() - t_case
    log(f"  {label}: case {out['case_s']:.1f} s")
    return out


def eval_inputs(cache, sl: slice, seed: int):
    """`evaluate`'s inputs for the cache rows `sl`, its noise included."""
    s3 = torch.as_tensor(cache.strokes[sl], dtype=torch.float32).cuda()
    text = torch.as_tensor(np.asarray(cache.text[sl], np.int64)).cuda()
    style = torch.as_tensor(cache.style[sl], dtype=torch.float32).cuda()
    gen = torch.Generator("cuda").manual_seed(seed * 1_000_003 + sl.start)
    return s3, text, style, torch.randn(s3[..., :2].shape, generator=gen, device="cuda")


def eval_graph_case(model, cache, label) -> tuple[dict, object]:
    """Phase 8d's eval case: `evaluate` through make_eval_fn (batch 96 over
    GRAPH_EVAL_ROWS rows: two full batches and a tail, two keys) against
    eager `eval_batch` on the same inputs. Fatal unless every batch is
    equal bit for bit, the mean is the eager one, each key captured once and
    the train kernels launch alike (9 attention and 6 conv-block launches a
    level with the flags, none without). Then eager against replayed ms for
    a batch of 96, in turns. Returns (the case, the eval step)."""
    from dhg_torch.eval import EvalGraphs, eval_batch, eval_levels, evaluate, make_eval_fn

    n, levels = len(cache), eval_levels()
    step, rows = make_eval_fn(model), []

    def recorded(*args):
        rows.append(step(*args))
        return rows[-1]

    reset_all_counts()
    t0 = time.perf_counter()
    got = evaluate(model, cache, batch_size=TRAIN_B, seed=0, eval_step=recorded)
    wall = time.perf_counter() - t0
    counted = {k: v for k, v in kernel_launches().items() if v}
    batches = [eval_inputs(cache, slice(i, min(i + TRAIN_B, n)), 0) for i in range(0, n, TRAIN_B)]
    reset_all_counts()
    want = [eval_batch(model, *b, levels) for b in batches]
    eager_counted = {k: v for k, v in kernel_launches().items() if v}
    forwards = len(batches) * len(levels)
    flags = os.environ.get("DHG_FUSED_ATTENTION") == "1"
    expected = {"fused_attention": 9 * forwards, "fused_conv_block": 6 * forwards} if flags else {}
    mean = np.average(np.stack([w.cpu().numpy() for w in want]), axis=0,
                      weights=[b[0].shape[0] for b in batches])
    same = {"graphs": isinstance(step, EvalGraphs) and step.captures == len(step.graphs) == 2,
            "batches": len(rows) == len(want) and all(torch.equal(a, b)
                                                      for a, b in zip(rows, want)),
            "mean": np.array_equal(got, mean),
            "launches": counted == eager_counted == expected}
    ms = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        call = (lambda: eval_batch(model, *batches[0], levels)) if mode == "eager" else (
            lambda: step(*batches[0]))
        ms[mode].append(event_ms(lambda: [call() for _ in range(3)])[1] / 3)
    out = {"value": [float(v) for v in got], "wall_s": wall, "launches": counted, "equal": same,
           "capture_s": [e[0].capture_s for e in step.graphs.values()], "batch_ms": ms}
    log(f"  {label}: evaluate over {n} rows at batch {TRAIN_B} ({len(batches)} batches, "
        f"{step.captures} captures, {out['capture_s']} s) {wall:.2f} s; equal to eager "
        f"eval_batch {same}; launches {counted} (want {expected}); a batch of {TRAIN_B}: eager "
        f"{', '.join(f'{v:.2f}' for v in ms['eager'])} ms, replayed "
        f"{', '.join(f'{v:.2f}' for v in ms['graph'])} ms")
    if not all(same.values()):
        fail(f"eval graph {label}: the replayed eval differs from eager eval_batch: {same}")
    return out, step


def graph_steps_phase(report, teacher_cfg, teacher):
    """Phase 8d: dhg's jitted distill step and eval step as CUDA graphs on
    the train phase's model (see the module docstring)."""
    import copy

    from dhg_torch.config import DLConfig, update_config
    from dhg_torch.data.pipeline import DeviceDataset, synthetic_cache
    from dhg_torch.distill import Distiller
    from dhg_torch.eval import eval_batch, eval_levels
    from dhg_torch.train import load_cache

    t_phase = time.perf_counter()
    out = {}

    def cfg_in(dtype):
        return DLConfig(update_config(copy.deepcopy(teacher_cfg.to_dict()),
                                      {"training_args.compute_dtype": dtype}))

    data = DeviceDataset.from_cache(load_cache(cfg_in("float32"), "train", "cuda"), "cuda")
    pairs = {dtype: {mode: Distiller(cfg_in(dtype), teacher, lr=5e-5, device="cuda")
                     for mode in ("eager", "graph")} for dtype in ("float32", "bfloat16")}
    try:
        for label, dtype, flags, timed, profiled in (
                ("f32 plain", "float32", False, True, False),
                ("f32 kernels", "float32", True, True, True),
                ("bf16 kernels", "bfloat16", True, False, False)):
            set_train_flags(flags)
            out[f"distill {label}"] = distill_graph_case(pairs[dtype], data, label, timed,
                                                         profiled)
            torch.cuda.empty_cache()
        da = teacher_cfg.dataset_args
        cache = synthetic_cache(n=GRAPH_EVAL_ROWS, max_seq_len=da.max_seq_len or 480,
                                max_text_len=da.max_text_len or 50, seed=777)
        # The bf16 teacher (its weights, eval mode, no grad) is the model scored.
        model = pairs["bfloat16"]["eager"].teacher
        for label in ("plain", "kernels"):
            set_train_flags(label == "kernels")
            out[f"eval bf16 {label}"], step = eval_graph_case(model, cache, f"eval bf16 {label}")
        # With the flags on: a weight changed in place is read by the next
        # replay; a weight whose storage is replaced makes the key capture again.
        batch, levels = eval_inputs(cache, slice(0, TRAIN_B), 0), eval_levels()
        first, caps = step(*batch), step.captures
        w = model.output_dense.weight
        with torch.no_grad():
            w.mul_(1.5)
        moved = step(*batch)
        in_place = (step.captures == caps and not torch.equal(moved, first)
                    and torch.equal(moved, eval_batch(model, *batch, levels)))
        with torch.no_grad():
            w.data = w.data * 0.5
        again = step(*batch)
        replaced = (step.captures == caps + 1
                    and torch.equal(again, eval_batch(model, *batch, levels)))
        log(f"  eval: a weight changed in place read by the replay {in_place}; a replaced "
            f"storage captured again {replaced}")
        if not (in_place and replaced):
            fail(f"eval graph: in place read {in_place}, replaced storage captured {replaced}")
        out["eval weights"] = {"in_place_read": in_place, "replaced_captured": replaced}
        del step, model, data, pairs
    finally:
        set_train_flags(False)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  distill and eval graphs phase {out['phase_s']:.1f} s (budget {GRAPH_PHASE_S:.0f} s)")
    report["graph_steps"] = out


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

    t_script = time.perf_counter()
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

    log("== build, on a background thread beside the serve phase (which runs no kernel)")
    t0 = time.perf_counter()
    built: dict = {}

    def run_build():
        try:
            built["path"] = build.build()
        except (RuntimeError, OSError) as e:
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    build_thread = threading.Thread(target=run_build, daemon=True)
    build_thread.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            log("== serve: dhg_torch.serve on a plain 20-step train run's model_final (f32, "
                "CUDA graphs)")
            serve_phase(plain_train_run(tmp), tmp, report)
    finally:
        build_thread.join()  # no nvcc left running, whatever the serve phase did
    if "error" in built:
        fail(f"kernel build failed: {built['error']}")
    try:
        build.load()
    except (RuntimeError, OSError) as e:
        fail(f"kernel library failed to load: {e}")
    report["build_s"] = built["s"]
    report["build_and_serve_s"] = time.perf_counter() - t0
    log(f"  build: {built['path'].name} in {report['build_s']:.1f} s; the build and the serve "
        f"phase beside it {report['build_and_serve_s']:.1f} s")

    model = DiffusionModel.from_config({"channels": 128, "att_layers_num": 2},
                                       dtype=torch.bfloat16, device="cuda", seed=0)
    with torch.inference_mode():
        log("== kernels against their plain versions (main-path shapes)")
        cases = kernel_phase(model, report)
        log("== train-path kernels against their plain versions (T 480, batch 96)")
        cases += train_kernel_phase(report)
        log("== denoise with kernels against the plain module path")
        denoise_phase(model, report)
        log("== T4 region kernel against its plain version (seq_len 392)")
        cases += t4_kernel_phase(model, report)
        log("== denoise through the T4 kernel against the plain module path")
        t4_denoise_phase(model, report)
        log("== the T4 kernel's yardstick: the default path over its region, a denoise step")
        region_phase(model, report)
    log("== backward of the autograd.Functions against the plain backward")
    gradient_phase(report)
    log("== sampler: sample_lines -> generate")
    generate_phase(model, report)
    t4_generate_phase(model, report)
    log("== sampler graphs: generate's eager call, capture and replay against _sample")
    replayed = graphs_phase(report)
    torch.cuda.empty_cache()
    log("== launches of a 10-step generate (profile_sampler.py), DHG_FUSED_T4 off and on")
    launch_profile_phase(model, report)
    log("== timings (DHG_FUSED_T4 off, on, on, off at each batch)")
    timing_phase(model, report)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        log("== train: dhg_torch.train.main, batch 96, both train-path kernels")
        train_counts, run = train_phase(report, tmp)
        log("== infer: the CLI on the train run's model_final (f32)")
        style_png, infer_strokes = infer_phase(run, tmp, report)
        log("== iam: a generated IAM tree -> caches -> train -> average -> eval, metrics")
        iam = iam_phase(report, tmp)
        log("== distill: dhg_torch.distill 60 -> 30 from the train run, flags off and on; "
            "infer, probe_distill, the bf16 probe")
        distill_phase(run, tmp, report)
        log("== multiprocess: the train CLI under torch.distributed (NCCL x 1, gloo DP 2, TP 2)")
        multiprocess_phase(tmp, report)
        log("== opt-in samplers and tools: full hoist, encoder reuse, Jacobi DDIM, training's "
            "profile_dir, dhg_torch/tools")
        optin_phase(run, tmp, report)
        log("== style trunk: the random init's scale, train_style_trunk, eval_style_gap, "
            "eval_fsd_sensitivity, eval_style_pathway")
        style_phase(iam, tmp, report)
        log("== converters: export_torch_checkpoint, convert_torch_checkpoint (bare, module.) "
            "and infer on its output, convert_torchvision_mnv2 into init_style_extractor")
        converters_phase(run, tmp, style_png, infer_strokes, report)
        from dhg_torch.config import DLConfig

        # Phase 8d's teacher: the train run's config and model_final, in f32.
        teacher_cfg = DLConfig.load(run / "config.yml")
        teacher = DiffusionModel.load(run / "model_final", dtype=None, device="cpu").state_dict()
    log("== train rate: kernels against the plain-op path")
    train_rate_phase(report)
    log("== chunks: steps_per_call's replayed chunks against eager steps, flags off and on")
    chunk_phase(report)
    log("== profile: dhg's train-step profile (tools/profile_train.py), flags off and on")
    profile_phase(report)
    log("== distill and eval graphs: make_step_fn and make_eval_fn replayed against eager, "
        "flags off and on")
    graph_steps_phase(report, teacher_cfg, teacher)

    def timed(name, keep):
        return [r for r in cases if r["kernel"] == name and keep(r)]

    kernels = [
        kernel_row("fused_bottleneck", cases,
                   timed("fused_bottleneck", lambda r: r["case"].endswith("B=96")),
                   replayed["B=96"][0], "bottleneck B=96"),
        kernel_row("fused_encoder_layer", cases,
                   timed("fused_encoder_layer", lambda r: r["case"] in ("enc3 B=96", "enc5 B=96")),
                   replayed["B=96"][1], "enc3 + enc5 B=96 (one launch of each a step)"),
        kernel_row("fused_attention", cases, timed("fused_attention", lambda r: True),
                   train_counts[0], "sum over one training forward's 9 calls, B=96, T=480"),
        kernel_row("fused_conv_block", cases, timed("fused_conv_block", lambda r: r["per_step"]),
                   train_counts[1], "sum over one training forward's 6 blocks, bf16, B=96, T=480"),
        kernel_row("fused_unet_t4", cases,
                   timed("fused_unet_t4", lambda r: r["case"] == "T4 region B=96"),
                   replayed["B=96 T4"][2], "T4 region B=96"),
    ]
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_script
    log(f"== done in {report['script_s']:.1f} s (build {report['build_s']:.1f} s)")
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
