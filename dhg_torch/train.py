"""Training (port of dhg/train.py).

    python -m dhg_torch.train --config=smoke.yml [--device=cpu] [--a.b.c=value ...]

Runs on the card unless --device=cpu. One step:
  * gathers a random batch from the device-resident cache;
  * classifier-free cond dropout and stroke augmentation (when configured);
  * continuous alpha_bar draws, noise, x_t;
  * forward (dropout live), loss, backward, in grad_accum micro-batches;
  * the optimizer chain of dhg's optax config: clip (norm | value | agc),
    L2 into the gradient, Adam, Noam learning rate; then the EMA shadow.
Loss scalars stay on the device and are fetched once per log line. With
DHG_FUSED_ATTENTION=1 / DHG_FUSED_CONVBLOCK=1 the forward takes the CUDA
kernels of kernels/fused_attention.py and kernels/fused_conv_block.py.

The run dir (work_dir/<name>/<dd.mm>/<HH.MM.SS>) gets run.log with the
reference's lines (`Step N | Loss: ... | Score: ... | Pen: ... | Time: ...
sec`), metrics.jsonl, checkpoint_<N>, model_final, config.yml and
report.json. SIGINT/SIGTERM save checkpoint_last and model_last at the next
step boundary. experiment.resume_from=<checkpoint_N> resumes params,
optimizer state, EMA and the step count.

Data: training_args.dataset "iam" (the default) builds or loads the packed
cache of experiment.data_dir's split (dhg_torch.data.iam, style vectors on
the training device); "synthetic" needs no files.

Multi-process runs (dhg_torch/parallel): training_args.distributed (or
DHG_COORDINATOR / DHG_NUM_PROCESSES / DHG_PROCESS_ID) forms the process
group, one process a device, and training_args.mesh lays the ranks out as
(data, model). Every rank draws the same global batch from the same seed
and takes its data index's rows; gradients and loss scalars are averaged
over the data group in one all-reduce before clipping and Adam, so the clip
sees the global gradient. model_parallel > 1 shards every FFN and attention
over the model group (parallel/sharding.py); the group must lie on one
host. Dropout masks are drawn for the whole batch from a generator seeded
per step, so a rank drops what a one-process run drops for the same rows.
Only rank 0 makes the run dir and writes run.log, metrics.jsonl,
checkpoints (gathered to dhg's full layout) and the report; the others log
nothing.

training_args.profile_dir traces steps profile_start (default 10) through
profile_start + profile_steps (default 5), both counted from 1 and both
included, as dhg's loop runs them, with torch.profiler (host operators and,
on CUDA, kernels; each step a `train_step <N>` span); rank 0 writes the
Chrome trace into profile_dir after the last of them.

training_args.steps_per_call (dhg's: "auto" or unset is up to 16 steps a
chunk, an integer that many, 1 the per-step loop) runs dhg's chunk loop:
each chunk ends at the run's end or before a save or validation boundary,
a boundary chunk is rounded down to a power of two, and the log lines,
metrics.jsonl rows, validations, saves and the interrupt latch come at
chunk ends from the chunk's stacked [k, 3] rows, with dhg's cadence and
text. A chunk of one step is train_step. On CUDA a longer chunk's steps
replay one captured CUDA graph of the step (StepGraph) back to back, with
no host sync between them; each step's draws, learning rate, bias
corrections and dropout seed are staged on the host before its replay, so
a replayed step equals the eager one bit for bit. On the CPU a chunk's
steps run eagerly one after another. Under NCCL the graph captures the
step's all-reduces too; train() drops it at its end, so that no captured
collective outlives the group main() then destroys. Under a process group
whose backend is not NCCL a CUDA chunk takes one step (see
steps_per_call); profile_dir forces one step a chunk, as in dhg.

The val_freq passes go through one eval step a run (Trainer.eval_fn,
eval.py::make_eval_fn, as dhg's Trainer caches its jitted one): on CUDA
each batch shape replays its captured graph from its second batch on, and
train() drops the step with the step graph at its end. Under a process
group whose backend is not NCCL they run eagerly on CUDA, which run.log
says once.
"""

from __future__ import annotations

import json
import logging
import signal
import socket
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn

from dhg_torch import resolve_device
from dhg_torch.checkpoint import AsyncSaver, load_checkpoint, save_checkpoint
from dhg_torch.config import DLConfig, config_entrypoint, object_from_dict, parse_cli_kwargs
from dhg_torch.core.losses import diffusion_loss
from dhg_torch.core.graphs import CapturedBody
from dhg_torch.core.schedule import alphas_from_draws, get_alpha_set
from dhg_torch.data.pipeline import (DeviceDataset, augment_matrices, augment_strokes,
                                     gather_batch, synthetic_cache)
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.ops.basic import clear_cast_caches, dropout_rows
from dhg_torch.parallel import distributed as dist
from dhg_torch.parallel.mesh import Mesh, make_mesh
from dhg_torch.parallel.sharding import (gather_state_dict, shard_dim, shard_model,
                                         shard_state_dict)
from dhg_torch.utils.experiment import ExperimentDir

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, None: None}


def noam_schedule(d_model: int, warmup_steps: int, lr_mul: float = 1.0):
    """lr(count) = lr_mul d_model^-0.5 min(n^-0.5, n warmup^-1.5), n = count + 1,
    in float32 as dhg computes it."""
    head = np.float32(lr_mul * d_model ** -0.5)
    ramp = np.float32(warmup_steps ** -1.5)

    def schedule(count: int) -> float:
        n = np.float32(count) + np.float32(1.0)
        return float(head * np.minimum(n ** np.float32(-0.5), n * ramp))

    return schedule


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule in float32: a linear ramp from
    init_value to peak_value over warmup_steps counts, then a cosine from
    peak_value to end_value that ends at count decay_steps and holds there.
    Like optax it raises ValueError when decay_steps <= warmup_steps."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps - warmup_steps}.")
    f32 = np.float32
    alpha = f32(0.0 if peak_value == 0.0 else end_value / peak_value)
    span = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        n = min(f32(count - warmup_steps), span)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * n / span))
        return float(f32(peak_value) * ((f32(1) - alpha) * cosine + alpha))

    return schedule


def agc_dims(module: nn.Module, p: torch.Tensor) -> tuple[int, ...]:
    """The dims optax's unitwise_norm reduces, in the torch layout of `p`:
    vectors (after squeeze) whole; else axis 0 of the flax layout, which is
    dim 1 of a Linear weight [out, in], dim 2 (the taps) of a Conv1d weight
    [out, in, k] and dim 0 of an Embedding [vocab, d]."""
    if p.squeeze().dim() <= 1:
        return tuple(range(p.dim()))
    if isinstance(module, nn.Embedding):
        return (0,)
    if isinstance(module, nn.Conv1d):
        return (2,)
    if isinstance(module, nn.Linear):
        return (1,)
    raise ValueError(f"no AGC rule for {type(module).__name__} weight {tuple(p.shape)}")


class Optimizer:
    """dhg's optax chain on a model's parameters, updated in place:
    clip -> (adam: + wd p) -> Adam moments -> (adamw: + wd p) -> * -lr(count)
    -> p += update. `stage` writes a step's learning rate and bias
    corrections into a device buffer, `update` reads them: every step stays
    on the device (no host sync), and one CUDA graph of `update` serves
    every step. With a model group (tensor parallelism) the norms of clip
    "norm" and "agc" sum the sharded parameters' squares over the group, so
    they are the whole model's."""

    def __init__(self, model: nn.Module, kind: str, schedule, betas=(0.9, 0.999),
                 weight_decay: float = 0.0, clip: float | None = None, clip_mode: str = "norm",
                 model_group=None):
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(kind)
        if clip is not None and clip_mode not in ("norm", "value", "agc"):
            raise KeyError(f"Unknown clip mode ({clip_mode}).")
        self.names, self.params, self.dims = [], [], []
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                self.names.append(f"{mname}.{pname}" if mname else pname)
                self.params.append(p)
                self.dims.append(agc_dims(mod, p) if clip_mode == "agc" else None)
        self.group = model_group
        self.shard = [shard_dim(n) if model_group is not None else None for n in self.names]
        self.kind, self.schedule, self.betas = kind, schedule, tuple(betas)
        self.wd, self.clip, self.clip_mode = weight_decay, clip, clip_mode
        self.count = 0
        adam = kind != "sgd"
        self.mu = [torch.zeros_like(p) for p in self.params] if adam else []
        self.nu = [torch.zeros_like(p) for p in self.params] if adam else []
        # -lr, 1 - b1^count, 1 - b2^count of the next update (see stage).
        self.scalars = torch.zeros(3, device=self.params[0].device)

    @torch.no_grad()
    def _clip(self, grads):
        c = self.clip
        if self.clip_mode == "value":
            torch._foreach_clamp_min_(grads, -c)
            torch._foreach_clamp_max_(grads, c)
        elif self.clip_mode == "norm":
            if self.group is None:
                norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            else:
                sq = [g.square().sum() for g in grads]
                sharded = torch.stack([q for q, d in zip(sq, self.shard) if d is not None]).sum()
                tdist.all_reduce(sharded, group=self.group)
                norm = (torch.stack([q for q, d in zip(sq, self.shard) if d is None]).sum()
                        + sharded).sqrt()
            keep = norm < c
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * c))
        else:  # agc: NFNet adaptive clipping, unit-wise
            for g, p, dims, sd in zip(grads, self.params, self.dims, self.shard):
                g_sq, p_sq = g.square().sum(dims, keepdim=True), p.square().sum(dims, keepdim=True)
                if sd in dims:  # the unit spans the model group's shards
                    tdist.all_reduce(g_sq, group=self.group)
                    tdist.all_reduce(p_sq, group=self.group)
                g_norm = g_sq.sqrt()
                max_norm = p_sq.sqrt().clamp_min(1e-3) * c
                clipped = g * (max_norm / g_norm.clamp_min(1e-6))
                g.copy_(torch.where(g_norm < max_norm, g, clipped))

    def step(self, grads: list[torch.Tensor]) -> None:
        """Apply one update from `grads` (modified in place)."""
        self.stage()
        self.update(grads)

    @torch.no_grad()
    def stage(self) -> None:
        """Write the next update's -lr(count) and Adam bias corrections
        into `self.scalars` (computed on the host in float32, as optax does,
        and filled in on the device without a sync); count += 1."""
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = (np.float32(b) for b in self.betas)
        n = np.float32(self.count)
        bc1, bc2 = np.float32(1) - b1 ** n, np.float32(1) - b2 ** n
        for slot, v in zip(self.scalars, (-lr, bc1, bc2)):
            slot.fill_(float(v))

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> None:
        """The update of `stage`'s scalars from `grads` (modified in place):
        device work only, so a CUDA graph can capture it."""
        if self.clip is not None:
            self._clip(grads)
        if self.kind == "adam" and self.wd:
            torch._foreach_add_(grads, self.params, alpha=self.wd)
        neg_lr, bc1, bc2 = self.scalars
        if self.kind == "sgd":
            updates = grads
        else:
            b1, b2 = self.betas
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
            updates = torch._foreach_div(self.mu, bc1)
            denom = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, 1e-8)
            torch._foreach_div_(updates, denom)
            if self.kind == "adamw" and self.wd:
                torch._foreach_add_(updates, self.params, alpha=self.wd)
        torch._foreach_mul_(updates, neg_lr)
        torch._foreach_add_(self.params, updates)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for mine, key in ((self.mu, "mu"), (self.nu, "nu")):
            for name, t in zip(self.names, mine):
                t.copy_(state[key][name])


def make_optimizer(cfg: DLConfig, model: nn.Module, lr_override: float | None = None,
                   model_group=None) -> Optimizer:
    """The optimizer of the reference YAML schema. lr_override replaces the
    Noam schedule with a constant learning rate (same chain otherwise).
    model_group: the tensor-parallel group of a sharded model."""
    kind, params = object_from_dict(dict(cfg.optimizer))
    ta = cfg.training_args
    if lr_override is not None:
        lr = float(lr_override)
        schedule = lambda _: lr  # noqa: E731
    else:
        schedule = noam_schedule(ta.channels * 2, ta.warmup_steps)
    return Optimizer(model, kind, schedule, betas=params.get("betas", [0.9, 0.999]),
                     weight_decay=params.get("weight_decay", 0.0) or 0.0,
                     clip=ta.clip_grad, clip_mode=ta.clip_mode or "norm",
                     model_group=model_group)


def load_cache(cfg: DLConfig, kind: str, device="cuda"):
    """The packed cache for 'train' or 'validation'.

    Synthetic runs (training_args.dataset: synthetic) hold out a validation
    set from seed + 777 (n = max(16, max_files // 4)). IAM runs read the
    split from experiment.splits_file through load_or_build_cache, whose
    style vectors are extracted on `device`: validation returns None when
    its split has no samples on disk; an empty train split raises."""
    ta = cfg.training_args
    if (ta.dataset or "iam") == "synthetic":
        if kind == "validation":
            n, seed = max(16, (ta.max_files or 64) // 4), (cfg.experiment.seed or 0) + 777
        else:
            n, seed = ta.max_files or 64, cfg.experiment.seed or 0
        return synthetic_cache(n=n, max_seq_len=cfg.dataset_args.max_seq_len or 480,
                               max_text_len=cfg.dataset_args.max_text_len or 50, seed=seed)
    from dhg_torch.data.iam import load_or_build_cache

    try:
        return load_or_build_cache(**iam_cache_kwargs(cfg, kind, device))
    except RuntimeError:  # no samples on disk for this split
        if kind == "validation":
            return None
        raise


def iam_cache_kwargs(cfg: DLConfig, kind: str, device="cuda") -> dict:
    """The arguments of load_or_build_cache for a config's IAM split."""
    ta, da = cfg.training_args, cfg.dataset_args
    return dict(
        cache_dir=ta.cache_dir or "./data/cache",
        data_dir=cfg.experiment.data_dir,
        kind=kind,
        splits_file=cfg.experiment.splits_file,
        img_height=da.img_height or 96,
        img_width=da.img_width or 1400,
        max_text_len=da.max_text_len or 50,
        max_seq_len=da.max_seq_len or 480,
        max_files=ta.max_files,
        seed=cfg.experiment.seed or 54321,
        style_weights=da.style_weights,
        device=device,
    )


class Draws(NamedTuple):
    """The random numbers of one step (all on the device)."""

    idx: torch.Tensor  # [B] batch rows
    alpha_idx: torch.Tensor  # [B, 1] lower schedule level
    alpha_u: torch.Tensor  # [B, 1] fraction between the two levels
    eps: torch.Tensor  # [B, T, 2] noise
    cond_drop: torch.Tensor | None = None  # [B] bool: null condition
    aug_u: torch.Tensor | None = None  # [3, B] uniforms of augment_matrices
    dropout_seed: int | None = None  # seeds the step's dropout masks (None: unseeded)

    def rows(self, sl: slice) -> "Draws":
        """The draws of batch rows `sl`."""
        pick = [None if v is None else v[sl] for v in self[:5]]
        aug = None if self.aug_u is None else self.aug_u[:, sl]
        return Draws(*pick, aug, self.dropout_seed)


class Trainer:
    """Owns the model, optimizer, dataset, mesh and the step.

    mesh: this rank's place in the (data, model) grid; by default the one
    training_args.mesh describes over the process group ((1, 1) without
    one). The model is built whole from the seed on every rank, then cut to
    this rank's shards."""

    def __init__(self, cfg: DLConfig, device="cuda", mesh: Mesh | None = None):
        self.cfg, self.device = cfg, resolve_device(device)
        ta = cfg.training_args
        if mesh is None:
            mcfg = ta.mesh if isinstance(ta.mesh, dict) else {}
            mesh = make_mesh(model_parallel=mcfg.get("model_parallel") or 1,
                             data_parallel=mcfg.get("data_parallel"))
        self.mesh = mesh
        self.write_artifacts = dist.is_main()
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.seed = cfg.experiment.seed or 0
        self.model = shard_model(DiffusionModel.from_config(
            ta, dtype=DTYPES[ta.compute_dtype], device=self.device, seed=self.seed).train(), mesh)
        self.opt = make_optimizer(cfg, self.model, model_group=mesh.model_group)
        self.batch_size = ta.batch_size
        if self.batch_size % mesh.data_size:
            raise ValueError(f"batch_size ({self.batch_size}) must split evenly over "
                             f"{mesh.data_size} data-parallel ranks")
        self.local_batch = self.batch_size // mesh.data_size
        self.alpha_set = get_alpha_set().to(self.device)
        self.ema_decay = float(ta.ema_decay or 0.0)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {self.ema_decay}")
        self.ema = [p.detach().clone() for p in self.opt.params] if self.ema_decay else None
        self.grad_accum = int(ta.grad_accum or 1)
        if self.grad_accum < 1 or self.local_batch % self.grad_accum:
            raise ValueError(f"grad_accum ({self.grad_accum}) must be >= 1 and divide "
                             f"the batch of a rank ({self.local_batch})")
        self.cond_dropout = float(ta.cond_dropout or 0.0)
        aug = cfg.dataset_args.augment or {}
        self.augment = {k: float(aug.get(k) or 0.0) for k in ("scale", "rotate", "shear")}
        self.augment_on = any(v > 0.0 for v in self.augment.values())
        self.data: DeviceDataset | None = None
        self.saver = AsyncSaver()
        self._gen = torch.Generator(self.device)
        self.graph: StepGraph | None = None
        self.forward_graph: StepGraph | None = None  # forward_chunk's
        self._eval_step = None  # eval_fn's

    def load_dataset(self) -> DeviceDataset:
        """The train cache on the device. With several processes rank 0
        loads (and builds) it first; the others then read its file."""
        if self.data is None:
            multi = dist.is_multiprocess()
            if multi and not dist.is_main():
                tdist.barrier()
            self.data = DeviceDataset.from_cache(load_cache(self.cfg, "train", self.device),
                                                 self.device)
            if multi and dist.is_main():
                tdist.barrier()
        return self.data

    # -- the step --------------------------------------------------------------

    def draw(self, count: int) -> Draws:
        """Step `count`'s random numbers, a function of (seed, count) alone,
        as dhg's fold_in(root_key, count): a resumed run draws the same."""
        seed = (self.seed + 1) * 2 ** 32 + count
        g = self._gen.manual_seed(seed)
        b, dev, data = self.batch_size, self.device, self.load_dataset()
        idx = torch.randint(0, data.size, (b,), generator=g, device=dev)
        aug_u = torch.rand((3, b), generator=g, device=dev) if self.augment_on else None
        drop = None
        if self.cond_dropout > 0.0:
            drop = torch.rand((b,), generator=g, device=dev) < self.cond_dropout
        a_idx = torch.randint(0, self.alpha_set.shape[0] - 1, (b, 1), generator=g, device=dev)
        a_u = torch.rand((b, 1), generator=g, device=dev)
        eps = torch.randn((b, data.strokes.shape[1], 2), generator=g, device=dev)
        return Draws(idx, a_idx, a_u, eps, drop, aug_u, seed)

    @contextmanager
    def _dropout_generator(self, seed: int | None):
        """The default generator of the device seeded with `seed` inside
        (restored after), so every rank draws the same masks."""
        if seed is None:
            yield
            return
        cuda = self.device.type == "cuda"
        with torch.random.fork_rng(devices=[self.device] if cuda else []):
            if cuda:
                with torch.cuda.device(self.device):
                    torch.cuda.manual_seed(seed)
            else:
                torch.default_generator.manual_seed(seed)
            yield

    def train_step(self, d: Draws) -> torch.Tensor:
        """One optimizer update from the global draws `d`, on this rank's
        rows; returns [3] (total, score, pen), the global batch's means, on
        the device."""
        self.opt.stage()
        with self._dropout_generator(d.dropout_seed):
            return self._step(d)

    def _step(self, d: Draws) -> torch.Tensor:
        """train_step's device work, after its host-side staging (the
        optimizer's scalars, the dropout seed): no host sync and no host
        value that changes from step to step, so StepGraph captures it."""
        # grad_accum: the same draws in equal micro-batches; the mean of their
        # losses and gradients equals the unsplit step when dropout is off.
        n = self.grad_accum
        metrics = torch.zeros(3, device=self.device)
        for losses in self._micro_losses(d):
            (losses[0] / n).backward()
            metrics += torch.stack(losses).detach()
        grads = [p.grad for p in self.opt.params]
        if self.mesh.data_group is not None:
            metrics = self._data_mean(grads, metrics)
        self.opt.update(grads)
        for p in self.opt.params:
            p.grad = None
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(self.ema, self.ema_decay)
                torch._foreach_add_(self.ema, self.opt.params, alpha=1.0 - self.ema_decay)
        return metrics / n

    def _micro_losses(self, d: Draws):
        """The step's forward: this rank's rows of draws `d` gathered,
        augmented, condition-dropped and noised, then for each of grad_accum
        micro-batches in turn the model (under the step's dropout rows) and
        diffusion_loss; yields each micro-batch's (total, score, pen). _step
        takes each one's backward before the next forward runs."""
        start = self.mesh.data_index * self.local_batch
        if self.mesh.data_size > 1:
            d = d.rows(slice(start, start + self.local_batch))
        strokes3, text, style = gather_batch(self.load_dataset().arrays, d.idx)
        if d.aug_u is not None:
            strokes3 = augment_strokes(augment_matrices(d.aug_u, **self.augment), strokes3)
        if d.cond_drop is not None:
            # Classifier-free guidance training: the null condition is
            # EOS-only text and zero style.
            null_text = torch.zeros_like(text)
            null_text[:, 0] = 1
            text = torch.where(d.cond_drop[:, None], null_text, text)
            style = torch.where(d.cond_drop[:, None, None], torch.zeros_like(style), style)
        x, pen = strokes3[..., :2], strokes3[..., 2]
        alphas = alphas_from_draws(d.alpha_idx, d.alpha_u, self.alpha_set)
        xt = alphas.sqrt()[..., None] * x + (1.0 - alphas).sqrt()[..., None] * d.eps
        mb = self.local_batch // self.grad_accum
        for i in range(self.grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            with dropout_rows(self.model, self.batch_size,
                              slice(start + sl.start, start + sl.stop)):
                eps_pred, pen_pred = self.model(xt[sl], text[sl], alphas[sl].sqrt(), style[sl])
            yield diffusion_loss(d.eps[sl], eps_pred, pen[sl], pen_pred, alphas[sl])

    @torch.no_grad()
    def _forward(self, d: Draws) -> torch.Tensor:
        """_step's forward alone (no grad, no update, no collective): the
        [3] losses of this rank's rows of draws `d`, summed as _step sums
        them. Device work only, so StepGraph captures it too."""
        metrics = torch.zeros(3, device=self.device)
        for losses in self._micro_losses(d):
            metrics += torch.stack(losses)
        return metrics / self.grad_accum

    def forward_step(self, d: Draws) -> torch.Tensor:
        """train_step's forward alone on draws `d`, at the current params
        and with the step's dropout seed: no gradient and no update. Returns
        [3] (total, score, pen), equal to the row train_step(d) returns from
        the same params (on one rank)."""
        with self._dropout_generator(d.dropout_seed):
            return self._forward(d)

    def train_chunk(self, first: int, k: int) -> torch.Tensor:
        """Steps first .. first + k - 1 (counted from 1) on their draws;
        returns their [k, 3] rows on the device. On CUDA every step replays
        one captured graph of the step (StepGraph, captured at the first
        chunk), with no host sync between the steps; the cast caches are
        dropped after the chunk (a replay does not bump the weights'
        versions). On the CPU the steps run one after another through
        train_step."""
        counts = range(first, first + k)
        if self.device.type != "cuda":
            return torch.stack([self.train_step(self.draw(c)) for c in counts])
        rows = torch.empty((k, 3), device=self.device)
        # The device's default generator is reseeded before each step and
        # restored after the chunk, as train_step restores it.
        graph = self.graph = self.graph or StepGraph(self)
        with torch.random.fork_rng(devices=[self.device]):
            for row, c in zip(rows, counts):
                graph.run(self.draw(c), row)
        clear_cast_caches(self.model)
        return rows

    def forward_chunk(self, first: int, k: int) -> torch.Tensor:
        """forward_step on the draws of steps first .. first + k - 1, at
        fixed params; returns their [k, 3] rows on the device. On CUDA every
        forward replays one captured graph of the step's forward
        (StepGraph(forward_only=True), captured at the first call); on the
        CPU the forwards run one after another."""
        counts = range(first, first + k)
        if self.device.type != "cuda":
            return torch.stack([self.forward_step(self.draw(c)) for c in counts])
        rows = torch.empty((k, 3), device=self.device)
        graph = self.forward_graph = self.forward_graph or StepGraph(self, forward_only=True)
        with torch.random.fork_rng(devices=[self.device]):
            for row, c in zip(rows, counts):
                graph.run(self.draw(c), row)
        return rows

    @torch.no_grad()
    def _data_mean(self, grads, metrics) -> torch.Tensor:
        """Average the gradients (in place) and the loss scalars over the
        data group in one all-reduce of a flat buffer; returns the scalars."""
        flat = torch.cat([metrics] + [g.reshape(-1) for g in grads])
        tdist.all_reduce(flat, group=self.mesh.data_group)
        flat /= self.mesh.data_size
        for g, part in zip(grads, flat[3:].split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        return flat[:3]

    def eval_fn(self):
        """The validation step (eval.py::make_eval_fn), built once and kept
        until train() ends: a step built per validation boundary would
        capture its graphs anew each time, as dhg's would recompile."""
        if self._eval_step is None:
            from dhg_torch.eval import make_eval_fn

            self._eval_step = make_eval_fn(self.model)
        return self._eval_step

    # -- state -----------------------------------------------------------------

    def _full(self, sd):
        """A dict keyed by parameter names in dhg's full layout (a collective
        over the model group when the model is sharded)."""
        return None if sd is None else gather_state_dict(sd, self.mesh.model_group)

    def _mine(self, sd):
        """This rank's shards of a full dict keyed by parameter names."""
        return shard_state_dict(sd, self.mesh.model_index, self.mesh.model_size)

    def ema_state_dict(self):
        if self.ema is None:
            return None
        return dict(zip(self.opt.names, self.ema))

    def checkpoint_state(self) -> dict:
        """state_dict, optimizer state and EMA in dhg's full layout: each
        rank of a model group must call it (the shards are gathered)."""
        opt = self.opt.state_dict()
        opt.update(mu=self._full(opt["mu"]), nu=self._full(opt["nu"]))
        return dict(state_dict=self._full(self.model.state_dict()), optimizer=opt,
                    ema_state_dict=self._full(self.ema_state_dict()))

    def resume(self, path) -> int:
        """Params, optimizer state, EMA and step from a checkpoint_<N> file."""
        ck = load_checkpoint(path)
        self.model.load_state_dict(self._mine(ck["state_dict"]), strict=True)
        if ck.get("optimizer") is not None:
            opt = dict(ck["optimizer"])
            opt.update(mu=self._mine(opt["mu"]), nu=self._mine(opt["nu"]))
            self.opt.load_state_dict(opt)
        if self.ema is not None:
            src = self._mine(ck.get("ema_state_dict") or ck["state_dict"])
            with torch.no_grad():
                for name, t in zip(self.opt.names, self.ema):
                    t.copy_(src[name])
        return int(ck.get("step", 0))

    # -- the loop ----------------------------------------------------------------

    def train(self, meta: dict, logger) -> None:
        cfg, ta = self.cfg, self.cfg.training_args
        self.load_dataset()
        start = 0
        if cfg.experiment.resume_from:
            start = self.resume(cfg.experiment.resume_from)
            logger.info(f"Resumed from {cfg.experiment.resume_from} at step {start}")
        val_cache = load_cache(cfg, "validation", self.device) if ta.val_freq else None
        logger.info(f"Starting train model, host: {meta['host_name']}, exp_dir: {meta['exp_dir']}\n")
        if dist.is_multiprocess():
            logger.info(f"{dist.process_count()} processes, mesh (data, model) {self.mesh.shape}")
        exp_dir = Path(meta["exp_dir"])
        t0 = time.time()
        window: list[torch.Tensor] = []
        main = self.write_artifacts

        def record(row: dict) -> None:
            if main:
                with open(exp_dir / "metrics.jsonl", "a") as f:
                    f.write(json.dumps(row) + "\n")

        def save(name: str, **kwargs) -> None:
            state = self.checkpoint_state()  # every rank: a gather under tensor parallelism
            if not main:
                return
            if name.startswith("model_"):
                state.pop("optimizer")
            self.saver.submit(exp_dir / name, **state, **kwargs)

        # dhg's window: 0 or unset means the default (`or`).
        prof_start, prof_steps = ta.profile_start or 10, ta.profile_steps or 5
        prof = None
        backend = tdist.get_backend() if tdist.is_initialized() else None
        k_max = steps_per_call(ta.steps_per_call, self.device, backend, ta.profile_dir, logger)
        if val_cache is not None and self.device.type == "cuda" and backend not in (None, "nccl"):
            logger.info(f"validation runs eagerly under the {backend} process group (a CUDA "
                        "graph cannot capture its collectives)")
        count = start
        try:
            for k in chunk_sizes(start, ta.steps, k_max, ta.save_freq,
                                 ta.val_freq if val_cache is not None else None):
                if k == 1:
                    count += 1
                    if ta.profile_dir and main and count == prof_start:
                        prof = self._start_profile()
                    with (nullcontext() if prof is None
                          else torch.profiler.record_function(f"train_step {count}")):
                        rows = self.train_step(self.draw(count))[None]
                    if prof is not None and count == prof_start + prof_steps:
                        self._stop_profile(prof, ta.profile_dir, prof_start, count)
                        prof = None
                        logger.info(f"Profiler trace written to {ta.profile_dir}")
                else:
                    rows = self.train_chunk(count + 1, k)
                    count += k
                if _InterruptFlag.pending:
                    _InterruptFlag.pending = False
                    raise KeyboardInterrupt
                # The reference's cadence: "Step c+1" after step c, averaged
                # over the steps since the last line (one fetch per line).
                base, j0 = count - k, 0
                for c in range(base + 1, count + 1):
                    if (c + 1) % ta.log_freq == 0:
                        window.append(rows[j0:c - base])
                        j0 = c - base
                        vals = torch.cat(window).mean(0).tolist()
                        window = []
                        el = time.time() - t0
                        logger.info(f"Step {c + 1} | Loss: {vals[0]:.3f} | Score: {vals[1]:.3f} | "
                                    f"Pen: {vals[2]:.3f} | Time: {el:.3f} sec")
                        record({"step": c + 1, "loss": vals[0], "score": vals[1],
                                "pen": vals[2], "time": round(el, 3)})
                if j0 < k:
                    window.append(rows[j0:])
                if val_cache is not None and (count + 1) % ta.val_freq == 0:
                    from dhg_torch.eval import evaluate

                    v = evaluate(self.model, val_cache, batch_size=min(self.batch_size, len(val_cache)),
                                 seed=self.seed, eval_step=self.eval_fn())
                    logger.info(f"Step {count + 1} | Val Loss: {v[0]:.3f} | "
                                f"Val Score: {v[1]:.3f} | Val Pen: {v[2]:.3f}")
                    record({"step": count + 1, "val_loss": float(v[0]),
                            "val_score": float(v[1]), "val_pen": float(v[2])})
                if (count + 1) % ta.save_freq == 0:
                    logger.info("Saving checkpoint...")
                    save(f"checkpoint_{count + 1}", step=count + 1,
                         meta={"run_name": meta.get("run_name", "")}, keep=ta.keep_checkpoints)
            logger.info("Training finished, saving model weights.")
            save("model_final")
            self.saver.wait()
            logger.info(str(exp_dir / "model_final"))
        except KeyboardInterrupt:
            # Under tensor parallelism every rank must see the signal (a
            # launcher such as torchrun forwards it): the save gathers.
            logger.info("Training interrupted by user.")
            self.saver.wait()
            state = self.checkpoint_state()
            if main:
                save_checkpoint(exp_dir / "checkpoint_last", step=count, **state)
                state.pop("optimizer")
                save_checkpoint(exp_dir / "model_last", **state)
        finally:
            if prof is not None:  # the run ended inside the window: no trace, as in dhg
                prof.stop()
            self.saver.wait()
            # Their pools back, and no captured collective left to hold the
            # process group's communicator when the group is destroyed.
            self.graph = self._eval_step = None

    def _start_profile(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir, first: int, last: int) -> None:
        """Stop `prof` after step `last`'s work is done; its Chrome trace
        goes to profile_dir/train_steps_<first>-<last>.json."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        path = Path(profile_dir) / f"train_steps_{first}-{last}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))


class StepGraph:
    """A trainer's step (Trainer._step) captured as one CUDA graph; `run`
    takes a step by replaying it, so a chunk's steps need no host sync.
    With forward_only the graph holds the step's forward alone
    (Trainer._forward: no grad, no update), and `run` stages no optimizer
    scalars.

    The graph is a core/graphs.py `CapturedBody` over the model's cast
    caches, whose static input is a copy of the first step's draws: the
    first `run` takes its step eagerly on a side stream, on those buffers,
    then captures; later runs replay. Before each the host copies the
    step's draws into the buffers, stages the optimizer's scalars
    (Optimizer.stage) and seeds the device's default generator with the
    step's dropout seed, whose seed and offset the replay reads. A failure
    to capture or replay raises: no step falls back to the eager path on a
    card.
    """

    def __init__(self, trainer: Trainer, forward_only: bool = False):
        self.trainer = trainer
        self.forward_only = forward_only
        self.body: CapturedBody | None = None

    def run(self, d: Draws, row: torch.Tensor) -> None:
        """Take the step of draws `d`; its [3] losses go to `row` (on the
        device, in stream order)."""
        t = self.trainer
        if self.body is None:
            draws = Draws(*(None if v is None else v.clone() for v in d[:6]))
            self.body = CapturedBody(t._forward if self.forward_only else t._step, (draws,),
                                     (t.model,), t.device)
        else:
            for buf, v in zip(self.body.inputs[0][:6], d[:6]):
                if buf is not None:
                    buf.copy_(v)
        if not self.forward_only:
            t.opt.stage()
        if d.dropout_seed is not None:
            with torch.cuda.device(t.device):
                torch.cuda.manual_seed(d.dropout_seed)
        row.copy_(self.body.run())


def steps_per_call(value, device, backend: str | None = None, profile_dir=None,
                   logger=None) -> int:
    """k_max, the most steps of one chunk, from training_args.steps_per_call
    (dhg's: "auto" or unset is 16, else max(1, int(value))). profile_dir
    forces 1, so the trace window lands on step boundaries. On CUDA under a
    process group whose `backend` is not NCCL (gloo: a CUDA graph cannot
    capture its collectives) "auto" is 1, said on `logger`, and an integer
    above 1 raises. On the CPU a chunk's steps run eagerly, under any group."""
    auto = value in (None, "auto")
    k_max = 16 if auto else max(1, int(value))
    if profile_dir:
        return 1
    if torch.device(device).type == "cuda" and backend not in (None, "nccl") and k_max > 1:
        if not auto:
            raise ValueError(f"training_args.steps_per_call={value}: on CUDA under a {backend} "
                             "process group a chunk takes 1 step (its collectives cannot be "
                             "captured in a CUDA graph); use 1, auto or the nccl backend")
        if logger is not None:
            logger.info(f"steps_per_call auto is 1 under the {backend} process group "
                        "(a CUDA graph cannot capture its collectives)")
        return 1
    return k_max


def _dist(c: int, f: int) -> int:
    """Steps from count c to the next (count + 1) % f == 0 boundary (dhg's)."""
    d = (f - (c + 1) % f) % f
    return d if d else f


def chunk_sizes(start: int, steps: int, k_max: int, save_freq: int,
                val_freq: int | None = None) -> list[int]:
    """dhg's chunk schedule (dhg/train.py:553-567) from count `start`: each
    chunk ends at the run's end or before a save (and, with val_freq, a
    validation) boundary, and a boundary chunk 1 < k < k_max is rounded
    down to a power of two."""
    out, count = [], start
    while count < steps:
        dists = [steps - count, _dist(count, save_freq)]
        if val_freq:
            dists.append(_dist(count, val_freq))
        k = min(k_max, *dists)
        if 1 < k < k_max:
            k = 1 << (k.bit_length() - 1)
        out.append(k)
        count += k
    return out


class _InterruptFlag:
    """Deferred-interrupt latch shared by the signal handlers and the loop."""

    pending = False


def _latch(signum, frame):
    _InterruptFlag.pending = True


def main(cfg: DLConfig, device="cuda") -> Trainer:
    """Train per `cfg` and write the run dir; returns the Trainer (its
    `exp_dir` is the run dir, None on a rank other than 0). A configured
    process group is formed first, and left again at the end.
    SIGINT/SIGTERM latch a save at the next step boundary, also for
    detached runs, where SIGINT arrives ignored."""
    # A group formed by the caller stays the caller's; one formed here is left at the end.
    joined = not tdist.is_initialized() and dist.initialize_from_config(cfg, device)
    try:
        trainer = Trainer(cfg, dist.run_device(device))
        if trainer.write_artifacts:
            exp = ExperimentDir(cfg, trainer.device)
            trainer.exp_dir, meta, logger = exp.path, exp.meta, exp.logger
            logger.info(f"Config:\n{cfg.pretty_text}\n")
        else:
            # Ranks other than 0 compute in lockstep but own no artifacts.
            trainer.exp_dir, exp = None, None
            meta = {"host_name": socket.gethostname(), "exp_dir": "", "run_name": ""}
            logger = logging.getLogger(f"dhg_torch.train.rank{dist.process_index()}")
            logger.handlers[:] = [logging.NullHandler()]
            logger.propagate = False
        old = {s: signal.signal(s, _latch) for s in (signal.SIGINT, signal.SIGTERM)}
        try:
            trainer.train(meta, logger)
        finally:
            for s, h in old.items():
                signal.signal(s, h)
        if exp is not None:
            exp.write_artifacts()
    finally:
        if joined:
            tdist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    kwargs = parse_cli_kwargs(help_text=__doc__)
    device = kwargs.pop("device", "cuda")
    main(config_entrypoint(kwargs=kwargs), device=device)
