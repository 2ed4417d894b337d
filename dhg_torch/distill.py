"""Progressive distillation: halve the sampler's step count by training
(port of dhg/distill.py; Salimans & Ho 2022, arXiv:2202.00512).

    python -m dhg_torch.distill --experiment_path=<teacher run dir> \
        [--steps=2000] [--student_steps=30] [--lr=5e-5] [--probe=True] \
        [--training_args.xx=yy ...] [--device=cpu]

A student copy of the teacher learns to match TWO teacher DDIM steps with
ONE of its own, on the grid of every second level of the teacher's
extended level array [1, abar_0, ..., abar_{N-1}]; student step i spans
teacher steps 2i+1 then 2i:

    entering level   a_in[i]  = abar_t[2i+1]
    teacher midpoint a_mid[i] = abar_t[2i]
    exit level       a_out[i] = abar_t[2i-1], or 1 at i == 0

A step draws batch rows, a student step i per row and noise; forms x_t from
the data x0; runs the frozen teacher two DDIM hops x_t -> x_mid -> x_r;
solves for the eps* that lands one student DDIM step on x_r,

    eps* = (x_r - sqrt(a_out/a_in) x_t) / (sqrt(1-a_out) - sqrt(a_out/a_in) sqrt(1-a_in)),

and takes one optimizer update on the truncated-SNR x0 MSE
(w = max(abar/(1-abar), 1)) plus the pen head's MSE against the teacher's
pen, weighted by alpha_bar. All three forwards run without dropout, as
dhg's (its model.apply gets no dropout rng): the student is in eval mode
while autograd records, so TextStyleEncoder's 0.3 style dropout stays off.
The teacher runs under torch.no_grad, so its casts are cached once.

On CUDA `distill` runs its steps through make_step_fn, dhg's jitted step:
the first step is taken eagerly on a side stream, then the step's device
work (Distiller._step) is captured as one CUDA graph (core/graphs.py
CapturedBody, over the teacher's and the student's cast caches), and every
later step copies its draws into the graph's static buffers, stages the
optimizer's scalars and replays it, with no host sync between steps. A
replayed step equals the eager `step` bit for bit. On the CPU the steps run
eagerly, one `step` after another.

dtype: a Distiller built directly computes in the config's compute_dtype;
the CLI distills and probes in float32 whatever the config says, as dhg's
main does (it swaps in load_model's float32 model).

The student's run dir is <name>_distill<k>: config.yml carries
training_args.distilled_steps = k, so `infer`, `serve` and `metrics` pick
(k steps, the halved grid, DDIM) with no flags. model_final is written in
the port's checkpoint format.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import NamedTuple

import torch

from dhg_torch import resolve_device
from dhg_torch.checkpoint import resolve_checkpoint, save_checkpoint
from dhg_torch.config import DLConfig, parse_cli_kwargs, update_config
from dhg_torch.core.graphs import CapturedBody
from dhg_torch.core.sampling import ddim_step
from dhg_torch.core.schedule import N_STEPS, get_alpha_set, halved_beta_set
from dhg_torch.data.pipeline import DeviceDataset, gather_batch
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.train import DTYPES, load_cache, make_optimizer

PROBE_PROMPT = "a probe line of text"
PROBE_SEED = 1234


class DistillDraws(NamedTuple):
    """The random numbers of one distillation step (on the device)."""

    idx: torch.Tensor  # [bs] batch rows
    i: torch.Tensor  # [bs, 1] student step index
    eps: torch.Tensor  # [bs, T, 2] noise


class Distiller:
    """One 2-for-1 halving round: teacher (frozen) -> student (trained).

    cfg is the teacher's run config; its training_args.distilled_steps
    (absent: the canonical 60) names the grid the teacher samples on.
    teacher_state is the teacher's state_dict. lr: a constant learning rate
    in place of the config's Noam schedule (None keeps the schedule).
    """

    def __init__(self, cfg: DLConfig, teacher_state: dict, student_steps: int | None = None,
                 lr: float | None = None, device="cuda"):
        ta = cfg.training_args
        self.cfg, self.lr, self.device = cfg, lr, resolve_device(device)
        self.teacher_steps = int(ta.distilled_steps or N_STEPS)
        self.student_steps = int(student_steps or self.teacher_steps // 2)
        if self.teacher_steps != 2 * self.student_steps:
            raise ValueError(
                f"one distillation round halves the grid: teacher "
                f"{self.teacher_steps} -> student {self.teacher_steps // 2}, "
                f"got student_steps={self.student_steps}"
            )
        if self.teacher_steps % 2 != 0:
            raise ValueError(f"teacher grid must be even, got {self.teacher_steps}")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        self.teacher = DiffusionModel.from_config(ta, dtype=DTYPES[ta.compute_dtype],
                                                  device=self.device)
        self.teacher.load_state_dict(teacher_state, strict=True)
        self.teacher.requires_grad_(False).eval()
        self.batch_size = ta.batch_size
        self.seed = cfg.experiment.seed or 0

        # Step-index tables (module docstring), float32 [k] each.
        abar_t = get_alpha_set(halved_beta_set(self.teacher_steps)).to(self.device)
        levels = torch.cat([torch.ones(1, dtype=abar_t.dtype, device=self.device), abar_t])
        self.a_in = abar_t[1::2]
        self.a_mid = abar_t[0::2]
        self.a_out = levels[0::2][: self.student_steps]
        self.graph: CapturedBody | None = None  # make_step_fn's, on CUDA
        self.init_state()

    # -- state ----------------------------------------------------------------

    def init_state(self) -> None:
        """The student starts as an exact copy of the teacher (paper sec. 3),
        with a fresh optimizer."""
        self.student = copy.deepcopy(self.teacher).requires_grad_(True).eval()
        self.opt = make_optimizer(self.cfg, self.student, lr_override=self.lr)

    # -- the step ---------------------------------------------------------------

    def draw(self, generator: torch.Generator, n_rows: int, seq_len: int) -> DistillDraws:
        bs, dev = self.batch_size, self.device
        idx = torch.randint(0, n_rows, (bs,), generator=generator, device=dev)
        i = torch.randint(0, self.student_steps, (bs, 1), generator=generator, device=dev)
        eps = torch.randn((bs, seq_len, 2), generator=generator, device=dev)
        return DistillDraws(idx, i, eps)

    def step(self, arrays, d: DistillDraws) -> torch.Tensor:
        """One optimizer update; returns [3] (total, score, pen) on the device."""
        self.opt.stage()
        return self._step(arrays, d)

    def _step(self, arrays, d: DistillDraws) -> torch.Tensor:
        """step's device work, after its host staging (the optimizer's
        scalars): no host sync and no host value that changes from step to
        step, so make_step_fn captures it."""
        strokes3, text, style = gather_batch(arrays, d.idx)
        x0 = strokes3[..., :2]
        at, am, ar = self.a_in[d.i], self.a_mid[d.i], self.a_out[d.i]  # [bs, 1]
        atb, amb, arb = at[..., None], am[..., None], ar[..., None]
        xt = torch.sqrt(atb) * x0 + torch.sqrt(1.0 - atb) * d.eps

        with torch.no_grad():  # the frozen teacher: two DDIM hops
            eps1, pen_t = self.teacher(xt, text, torch.sqrt(at), style)
            x_mid = ddim_step(xt, eps1, atb, amb)
            eps2, _ = self.teacher(x_mid, text, torch.sqrt(am), style)
            x_r = ddim_step(x_mid, eps2, amb, arb)
            # The eps a one-step student DDIM needs to land on x_r exactly.
            ratio = torch.sqrt(arb / atb)
            denom = torch.sqrt(1.0 - arb) - ratio * torch.sqrt(1.0 - atb)
            eps_star = (x_r - ratio * xt) / denom
            x0_star = (xt - torch.sqrt(1.0 - atb) * eps_star) / torch.sqrt(atb)

        eps_pred, pen_pred = self.student(xt, text, torch.sqrt(at), style)
        x0_pred = (xt - torch.sqrt(1.0 - atb) * eps_pred) / torch.sqrt(atb)
        w = torch.clamp_min(atb / (1.0 - atb), 1.0)  # truncated SNR
        score = (w * (x0_pred - x0_star) ** 2).sum(dim=-1).mean()
        pen_l = (((pen_pred - pen_t) ** 2).mean(dim=-1) * at[:, 0]).mean()
        total = score + pen_l
        total.backward()
        self.opt.update([p.grad for p in self.opt.params])
        for p in self.opt.params:
            p.grad = None
        return torch.stack([total, score, pen_l]).detach()

    def make_step_fn(self, data: DeviceDataset):
        """step(d) -> [3] (total, score, pen) on the device: one update of
        the current student from draws `d` (dhg's make_step_fn). On CUDA the
        first call takes its step eagerly and captures `_step` on copies of
        its draws (self.graph); later calls copy their draws in, stage the
        optimizer's scalars and replay, and return a copy of the graph's
        row. The graph reads this student and optimizer: build a new step
        after init_state. On the CPU each call is `step`."""
        arrays = data.arrays
        if self.device.type != "cuda":
            return lambda d: self.step(arrays, d)
        graph = None

        def step(d: DistillDraws) -> torch.Tensor:
            nonlocal graph
            if graph is None:
                draws = DistillDraws(*(v.clone() for v in d))
                graph = self.graph = CapturedBody(self._step, (arrays, draws),
                                                  (self.teacher, self.student), self.device)
            else:
                for buf, v in zip(graph.inputs[1], d):
                    buf.copy_(v)
            self.opt.stage()
            return graph.run().clone()

        return step

    # -- the loop ---------------------------------------------------------------

    def distill(self, data: DeviceDataset, steps: int, logger, log_freq: int = 50) -> dict:
        """`steps` updates from a fresh student through make_step_fn; returns
        its state_dict. Draws come from one generator seeded seed + 99; the
        loss scalars are fetched once per log line. The step's graph is
        dropped at the end: the next init_state makes a student it does not
        read."""
        self.init_state()
        step_fn = self.make_step_fn(data)
        gen = torch.Generator(self.device).manual_seed(self.seed + 99)
        seq_len = data.strokes.shape[1]
        s = time.time()
        window: list[torch.Tensor] = []
        try:
            for c in range(1, steps + 1):
                window.append(step_fn(self.draw(gen, data.size, seq_len)))
                if c % log_freq == 0 or c == steps:
                    vals = torch.stack(window).mean(0).tolist()
                    logger.info(
                        f"Distill {self.teacher_steps}->{self.student_steps} | "
                        f"Step {c} | Loss: {vals[0]:.4f} | Score: {vals[1]:.4f} | "
                        f"Pen: {vals[2]:.4f} | Time: {time.time() - s:.3f} sec"
                    )
                    window = []
        finally:
            self.graph = None
        return self.student.state_dict()


def probe_samples(teacher, student, teacher_steps: int, student_steps: int,
                  x_init: torch.Tensor | None = None, device="cuda"):
    """(teacher 2k-step DDIM, student k-step DDIM) strokes [1, T, 3] on the
    probe prompt with zero style, both from one x_T (drawn from a generator
    seeded 1234 unless given)."""
    from dhg_torch.core.sampling import infer_seq_len
    from dhg_torch.data.tokenizer import Tokenizer
    from dhg_torch.inference import generate

    dev = resolve_device(device)
    text = torch.tensor([Tokenizer().encode(PROBE_PROMPT)], dtype=torch.long)
    style = torch.zeros((1, 14, 1280))
    seq_len = infer_seq_len(text.shape[1])
    if x_init is None:
        gen = torch.Generator(dev).manual_seed(PROBE_SEED)
        x_init = torch.randn((1, seq_len, 2), generator=gen, device=dev)
    kw = dict(seq_len=seq_len, diffusion_mode="ddim", schedule="halved", device=dev)
    outs = []
    for model, n in ((teacher, teacher_steps), (student, student_steps)):
        outs.append(generate(model, text, style, n_steps=n, x_init=x_init,
                             noises=torch.zeros((n, 1, seq_len, 2), device=dev), **kw))
    return tuple(outs)


def probe_fidelity(teacher, student, teacher_steps: int, student_steps: int, logger,
                   device="cuda") -> float:
    """Student k-step DDIM against teacher 2k-step DDIM from the same x_T on
    the probe prompt: the quantity distillation minimizes, logged as the
    round's summary number. Returns the stroke-delta MSE."""
    ref, out = probe_samples(teacher, student, teacher_steps, student_steps, device=device)
    mse = float(((ref[..., :2] - out[..., :2]) ** 2).mean())
    logger.info(
        f"Probe: student {student_steps}-step DDIM vs teacher "
        f"{teacher_steps}-step DDIM stroke MSE = {mse:.3e}"
    )
    return mse


def main(argv=None) -> Path:
    """The CLI; returns the student's run dir."""
    from dhg_torch.utils.experiment import ExperimentDir

    kw = parse_cli_kwargs(argv, help_text=__doc__)
    device = resolve_device(kw.pop("device", "cuda"))
    exp_path = kw.pop("experiment_path", None)
    if not exp_path:
        raise SystemExit("--experiment_path=<teacher run dir> is required")
    steps = int(kw.pop("steps", 2000))
    student_steps = kw.pop("student_steps", None)
    probe = bool(kw.pop("probe", True))
    lr = kw.pop("lr", None)
    lr = float(lr) if lr is not None else None
    kw.pop("config", None)  # the teacher's resolved config.yml is the config

    exp = Path(exp_path)
    ckpt = resolve_checkpoint(exp)
    if ckpt is None:
        raise SystemExit(f"no checkpoint found under {exp}")
    cfg = DLConfig.load(exp / "config.yml")
    if kw:
        cfg = DLConfig(update_config(cfg.to_dict(), kw))

    def updated(changes: dict) -> DLConfig:
        return DLConfig(update_config(copy.deepcopy(cfg.to_dict()), changes))

    teacher = DiffusionModel.load(ckpt, dtype=None, device=device)  # float32, as dhg's load_model
    d = Distiller(updated({"training_args.compute_dtype": "float32"}), teacher.state_dict(),
                  student_steps=student_steps, lr=lr, device=device)

    out_cfg = updated({
        "experiment.name": f"{cfg.experiment.name}_distill{d.student_steps}",
        "training_args.distilled_steps": d.student_steps,
    })
    run = ExperimentDir(out_cfg, device, logger_name="dhg_torch.distill")
    logger = run.logger
    logger.info(f"Distilling {exp} ({d.teacher_steps} steps) -> {d.student_steps} steps, "
                f"{steps} optimizer steps")
    data = DeviceDataset.from_cache(load_cache(cfg, "train", device), device)
    student = d.distill(data, steps, logger)

    save_checkpoint(run.path / "model_final", student)
    out_cfg.dump(run.path / "config.yml")
    logger.info(f"Student saved: {run.path / 'model_final'}")
    if probe:
        probe_fidelity(d.teacher, d.student, d.teacher_steps, d.student_steps, logger,
                       device=device)
    return run.path


if __name__ == "__main__":
    main()
