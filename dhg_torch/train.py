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

Not in the port yet: training_args.steps_per_call is ignored (dhg scans K
steps in one TPU program; here each step is its own call); profile_dir is
ignored; a mesh with model_parallel > 1 raises.
"""

from __future__ import annotations

import json
import signal
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from dhg_torch import resolve_device
from dhg_torch.checkpoint import AsyncSaver, load_checkpoint, save_checkpoint
from dhg_torch.config import DLConfig, config_entrypoint, object_from_dict, parse_cli_kwargs
from dhg_torch.core.losses import diffusion_loss
from dhg_torch.core.schedule import alphas_from_draws, get_alpha_set
from dhg_torch.data.pipeline import (DeviceDataset, augment_matrices, augment_strokes,
                                     gather_batch, synthetic_cache)
from dhg_torch.models.denoiser import DiffusionModel
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
    clip -> (adam: + wd p) -> Adam moments -> (adamw: + wd p) -> * lr(count)
    -> p -= update. Every step stays on the device: no host sync."""

    def __init__(self, model: nn.Module, kind: str, schedule, betas=(0.9, 0.999),
                 weight_decay: float = 0.0, clip: float | None = None, clip_mode: str = "norm"):
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
        self.kind, self.schedule, self.betas = kind, schedule, tuple(betas)
        self.wd, self.clip, self.clip_mode = weight_decay, clip, clip_mode
        self.count = 0
        adam = kind != "sgd"
        self.mu = [torch.zeros_like(p) for p in self.params] if adam else []
        self.nu = [torch.zeros_like(p) for p in self.params] if adam else []

    @torch.no_grad()
    def _clip(self, grads):
        c = self.clip
        if self.clip_mode == "value":
            torch._foreach_clamp_min_(grads, -c)
            torch._foreach_clamp_max_(grads, c)
        elif self.clip_mode == "norm":
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            keep = norm < c
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * c))
        else:  # agc: NFNet adaptive clipping, unit-wise
            for g, p, dims in zip(grads, self.params, self.dims):
                g_norm = g.square().sum(dims, keepdim=True).sqrt()
                max_norm = p.square().sum(dims, keepdim=True).sqrt().clamp_min(1e-3) * c
                clipped = g * (max_norm / g_norm.clamp_min(1e-6))
                g.copy_(torch.where(g_norm < max_norm, g, clipped))

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """Apply one update from `grads` (modified in place)."""
        if self.clip is not None:
            self._clip(grads)
        if self.kind == "adam" and self.wd:
            torch._foreach_add_(grads, self.params, alpha=self.wd)
        lr = self.schedule(self.count)
        self.count += 1
        if self.kind == "sgd":
            updates = grads
        else:
            b1, b2 = self.betas
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
            updates = torch._foreach_div(self.mu, bc1)
            denom = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, 1e-8)
            torch._foreach_div_(updates, denom)
            if self.kind == "adamw" and self.wd:
                torch._foreach_add_(updates, self.params, alpha=self.wd)
        torch._foreach_add_(self.params, updates, alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for mine, key in ((self.mu, "mu"), (self.nu, "nu")):
            for name, t in zip(self.names, mine):
                t.copy_(state[key][name])


def make_optimizer(cfg: DLConfig, model: nn.Module, lr_override: float | None = None
                   ) -> Optimizer:
    """The optimizer of the reference YAML schema. lr_override replaces the
    Noam schedule with a constant learning rate (same chain otherwise)."""
    kind, params = object_from_dict(dict(cfg.optimizer))
    ta = cfg.training_args
    if lr_override is not None:
        lr = float(lr_override)
        schedule = lambda _: lr  # noqa: E731
    else:
        schedule = noam_schedule(ta.channels * 2, ta.warmup_steps)
    return Optimizer(model, kind, schedule, betas=params.get("betas", [0.9, 0.999]),
                     weight_decay=params.get("weight_decay", 0.0) or 0.0,
                     clip=ta.clip_grad, clip_mode=ta.clip_mode or "norm")


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


class Trainer:
    """Owns the model, optimizer, dataset and the step."""

    def __init__(self, cfg: DLConfig, device="cuda"):
        self.cfg, self.device = cfg, resolve_device(device)
        ta = cfg.training_args
        mesh = ta.mesh if isinstance(ta.mesh, dict) else {}
        if (mesh.get("model_parallel") or 1) > 1:
            raise NotImplementedError("model_parallel > 1: the port trains on one device so far")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.seed = cfg.experiment.seed or 0
        self.model = DiffusionModel.from_config(
            ta, dtype=DTYPES[ta.compute_dtype], device=self.device, seed=self.seed).train()
        self.opt = make_optimizer(cfg, self.model)
        self.batch_size = ta.batch_size
        self.alpha_set = get_alpha_set().to(self.device)
        self.ema_decay = float(ta.ema_decay or 0.0)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {self.ema_decay}")
        self.ema = [p.detach().clone() for p in self.opt.params] if self.ema_decay else None
        self.grad_accum = int(ta.grad_accum or 1)
        if self.grad_accum < 1 or self.batch_size % self.grad_accum:
            raise ValueError(f"grad_accum ({self.grad_accum}) must be >= 1 and divide "
                             f"batch_size ({self.batch_size})")
        self.cond_dropout = float(ta.cond_dropout or 0.0)
        aug = cfg.dataset_args.augment or {}
        self.augment = {k: float(aug.get(k) or 0.0) for k in ("scale", "rotate", "shear")}
        self.augment_on = any(v > 0.0 for v in self.augment.values())
        self.data: DeviceDataset | None = None
        self.saver = AsyncSaver()
        self._gen = torch.Generator(self.device)

    def load_dataset(self) -> DeviceDataset:
        if self.data is None:
            self.data = DeviceDataset.from_cache(load_cache(self.cfg, "train", self.device),
                                                 self.device)
        return self.data

    # -- the step --------------------------------------------------------------

    def draw(self, count: int) -> Draws:
        """Step `count`'s random numbers, a function of (seed, count) alone,
        as dhg's fold_in(root_key, count): a resumed run draws the same."""
        g = self._gen.manual_seed((self.seed + 1) * 2 ** 32 + count)
        b, dev, data = self.batch_size, self.device, self.load_dataset()
        idx = torch.randint(0, data.size, (b,), generator=g, device=dev)
        aug_u = torch.rand((3, b), generator=g, device=dev) if self.augment_on else None
        drop = None
        if self.cond_dropout > 0.0:
            drop = torch.rand((b,), generator=g, device=dev) < self.cond_dropout
        a_idx = torch.randint(0, self.alpha_set.shape[0] - 1, (b, 1), generator=g, device=dev)
        a_u = torch.rand((b, 1), generator=g, device=dev)
        eps = torch.randn((b, data.strokes.shape[1], 2), generator=g, device=dev)
        return Draws(idx, a_idx, a_u, eps, drop, aug_u)

    def train_step(self, d: Draws) -> torch.Tensor:
        """One optimizer update; returns [3] (total, score, pen) on the device."""
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

        # grad_accum: the same draws in equal micro-batches; the mean of their
        # losses and gradients equals the unsplit step when dropout is off.
        n, mb = self.grad_accum, self.batch_size // self.grad_accum
        metrics = torch.zeros(3, device=self.device)
        for i in range(n):
            sl = slice(i * mb, (i + 1) * mb)
            eps_pred, pen_pred = self.model(xt[sl], text[sl], alphas[sl].sqrt(), style[sl])
            losses = diffusion_loss(d.eps[sl], eps_pred, pen[sl], pen_pred, alphas[sl])
            (losses[0] / n).backward()
            metrics += torch.stack(losses).detach()
        grads = [p.grad for p in self.opt.params]
        self.opt.step(grads)
        for p in self.opt.params:
            p.grad = None
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(self.ema, self.ema_decay)
                torch._foreach_add_(self.ema, self.opt.params, alpha=1.0 - self.ema_decay)
        return metrics / n

    # -- state -----------------------------------------------------------------

    def ema_state_dict(self):
        if self.ema is None:
            return None
        return dict(zip(self.opt.names, self.ema))

    def resume(self, path) -> int:
        """Params, optimizer state, EMA and step from a checkpoint_<N> file."""
        ck = load_checkpoint(path)
        self.model.load_state_dict(ck["state_dict"], strict=True)
        if ck.get("optimizer") is not None:
            self.opt.load_state_dict(ck["optimizer"])
        if self.ema is not None:
            src = ck.get("ema_state_dict") or ck["state_dict"]
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
        exp_dir = Path(meta["exp_dir"])
        t0 = time.time()
        window: list[torch.Tensor] = []

        def record(row: dict) -> None:
            with open(exp_dir / "metrics.jsonl", "a") as f:
                f.write(json.dumps(row) + "\n")

        count = start
        try:
            while count < ta.steps:
                count += 1
                window.append(self.train_step(self.draw(count)))
                if _InterruptFlag.pending:
                    _InterruptFlag.pending = False
                    raise KeyboardInterrupt
                # The reference's cadence: "Step c+1" after step c, averaged
                # over the steps since the last line (one fetch per line).
                if (count + 1) % ta.log_freq == 0:
                    vals = torch.stack(window).mean(0).tolist()
                    window = []
                    el = time.time() - t0
                    logger.info(f"Step {count + 1} | Loss: {vals[0]:.3f} | Score: {vals[1]:.3f} | "
                                f"Pen: {vals[2]:.3f} | Time: {el:.3f} sec")
                    record({"step": count + 1, "loss": vals[0], "score": vals[1],
                            "pen": vals[2], "time": round(el, 3)})
                if val_cache is not None and (count + 1) % ta.val_freq == 0:
                    from dhg_torch.eval import evaluate

                    v = evaluate(self.model, val_cache, batch_size=min(self.batch_size, len(val_cache)),
                                 seed=self.seed)
                    logger.info(f"Step {count + 1} | Val Loss: {v[0]:.3f} | "
                                f"Val Score: {v[1]:.3f} | Val Pen: {v[2]:.3f}")
                    record({"step": count + 1, "val_loss": float(v[0]),
                            "val_score": float(v[1]), "val_pen": float(v[2])})
                if (count + 1) % ta.save_freq == 0:
                    logger.info("Saving checkpoint...")
                    self.saver.submit(exp_dir / f"checkpoint_{count + 1}", self.model.state_dict(),
                                      optimizer=self.opt.state_dict(), step=count + 1,
                                      meta={"run_name": meta.get("run_name", "")},
                                      ema_state_dict=self.ema_state_dict(),
                                      keep=ta.keep_checkpoints)
            logger.info("Training finished, saving model weights.")
            self.saver.submit(exp_dir / "model_final", self.model.state_dict(),
                              ema_state_dict=self.ema_state_dict())
            self.saver.wait()
            logger.info(str(exp_dir / "model_final"))
        except KeyboardInterrupt:
            logger.info("Training interrupted by user.")
            self.saver.wait()
            save_checkpoint(exp_dir / "checkpoint_last", self.model.state_dict(),
                            optimizer=self.opt.state_dict(), step=count,
                            ema_state_dict=self.ema_state_dict())
            save_checkpoint(exp_dir / "model_last", self.model.state_dict(),
                            ema_state_dict=self.ema_state_dict())
        finally:
            self.saver.wait()


class _InterruptFlag:
    """Deferred-interrupt latch shared by the signal handlers and the loop."""

    pending = False


def _latch(signum, frame):
    _InterruptFlag.pending = True


def main(cfg: DLConfig, device="cuda") -> Trainer:
    """Train per `cfg` and write the run dir; returns the Trainer (its
    `exp_dir` is the run dir). SIGINT/SIGTERM latch a save at the next step
    boundary, also for detached runs, where SIGINT arrives ignored."""
    trainer = Trainer(cfg, device)
    exp = ExperimentDir(cfg, trainer.device)
    trainer.exp_dir = exp.path
    exp.logger.info(f"Config:\n{cfg.pretty_text}\n")
    old = {s: signal.signal(s, _latch) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        trainer.train(exp.meta, exp.logger)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    exp.write_artifacts()
    return trainer


if __name__ == "__main__":
    kwargs = parse_cli_kwargs(help_text=__doc__)
    device = kwargs.pop("device", "cuda")
    main(config_entrypoint(kwargs=kwargs), device=device)
