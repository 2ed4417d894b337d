"""The serving runtime with continuous batching (port of dhg/serve.py).

    python -m dhg_torch.serve --experiment_path=<run dir> [--port=8008] \
        [--source=<style image>[,style2.png,...]] [--warmup_buckets=200,400] \
        [--warm_steps=30] [--warm_modes=new,standard,ddim] \
        [--warm_temps=0.7,1.3] [--max_batch=16] [--batch_window_ms=5] \
        [--device=cpu]

Loads the model once (float32, as dhg's serve does), warms the sampler for a
set of sequence-length buckets, then serves:

  POST /generate   {"prompt": str, "seed": int?, "diffusion_mode": str?,
                    "guidance_scale": float?, "n_steps": int?,
                    "temperature": float?, "style": int | [float, ...]?,
                    "wrap": int?, "line_gap": float?, "align": str?}
      -> {"strokes": [[dx, dy, pen], ...], "seq_len": int, "ms": float,
          "truncated": bool}
      With "wrap": paragraph mode: the prompt is word-wrapped into lines of
      <= wrap chars, every line goes through the same batching queue (line
      i draws its noise from seed + i), and "strokes" is one composed page
      (utils.vis.compose_lines) with "lines" in place of "seq_len".
  GET  /healthz    -> {"ok": true, "buckets": [...], "warm_steps": [...],
                       "warm_modes": [...], "warm_temps": [...],
                       "styles": int, "stats": {...}}

Style bank: --source takes a comma-separated list of style images, one bank
entry each. A request picks an entry ("style": 1) or blends entries
("style": [0.3, 0.7], one weight per entry); omitted = entry 0. Styles are
batched inputs, so requests with different styles share a batch.

Continuous batching: requests land in a queue; one batcher thread takes the
compatible ones (same mode, guidance, bucket, n_steps, temperature) inside
a short window and samples them as one batch, padded to a power of two.
Each request keeps its own noise stream (core.sampling.
per_sample_noise_streams, from its seed), so its strokes are the same alone
or co-batched, to float32 tolerance.

On the card every batch replays a captured CUDA graph (core.graphs.
SamplerGraphs), one per (bucket, padded batch, mode, guided, n_steps,
temperature): the counterpart of dhg's compiled programs. warmup() captures
them through the queue, on the batcher thread, which does every device
operation of a request (style blend, copies in, replay, copy out); HTTP
threads touch no CUDA tensor. A variant that was not warmed is captured
live, ahead of the requests behind it, and kept; stats["captures"] counts
the graphs. n_steps, modes and temperatures are accepted only where warmed
(400 otherwise); prompts longer than every warmed bucket clamp to the
largest. A failed capture or replay fails its batch's requests (HTTP 500):
the service never samples eagerly on the card and never moves to the CPU.
With --device=cpu the batcher calls `generate` eagerly, once per batch.

SIGTERM or SIGINT drains: new requests get 503, queued and in-flight ones
finish, then the process exits. A distilled student (config
training_args.distilled_steps) coarsens n_steps on the "halved" grid,
defaults to (n_steps=distilled_steps, ddim), and main() warms both.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from dhg_torch import resolve_device
from dhg_torch.core.sampling import infer_seq_len, per_sample_noise_streams
from dhg_torch.core.schedule import N_STEPS
from dhg_torch.data.tokenizer import Tokenizer

# Power-of-two co-batch sizes; a service uses the prefix up to its max_batch.
BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class Draining(RuntimeError):
    """Raised for requests arriving after shutdown() began: HTTP 503."""


@dataclass
class _Pending:
    tokens: list[int]
    seed: int
    mode: str
    guidance: float | None
    bucket: int
    n_steps: int | None = None  # None = canonical 60-step schedule
    temperature: float = 1.0
    style_w: tuple[float, ...] | None = None  # bank weights; None = entry 0
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    seq_len: int = 0
    error: Exception | None = None
    t_submit: float = 0.0  # perf_counter() when it entered the queue

    def group_key(self):
        # The bucket is in the key because a request's noise stream depends
        # on its sequence length; n_steps and temperature select another
        # graph. Styles are batched inputs, so they are not in the key.
        return (self.mode, self.guidance, self.bucket, self.n_steps, self.temperature)


class GenerationService:
    """Owns the model, the style bank, the tokenizer, the sampler graphs
    (on CUDA) and the continuous-batching queue."""

    def __init__(
        self,
        model,
        style,
        max_text_len: int = 50,
        batch_window_ms: float = 5.0,
        max_batch: int = 16,
        max_page_lines: int = 64,
        device: str | torch.device = "cuda",
    ):
        if max_batch not in BATCH_SIZES:
            raise ValueError(f"max_batch must be one of {BATCH_SIZES}, got {max_batch}")
        self.device = resolve_device(device)
        self.model = model
        # Style bank [S, 14, 1280]; a single [1, 14, 1280] style is a bank of one.
        self.styles = torch.as_tensor(style, dtype=torch.float32).to(self.device)
        self.n_styles = int(self.styles.shape[0])
        self.graphs = None
        if self.device.type == "cuda":
            from dhg_torch.core.graphs import SamplerGraphs

            self.graphs = SamplerGraphs(model, self.device)
        self.tokenizer = Tokenizer()
        self.max_text_len = max_text_len
        self.batch_window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.batch_sizes = tuple(b for b in BATCH_SIZES if b <= max_batch)
        # Every wrapped line is a job; longer pages get a 400.
        self.max_page_lines = max_page_lines
        # How n_steps coarsens the schedule: "halved" for a distilled
        # student (from_experiment), else "strided".
        self.schedule = "strided"
        self.distilled_steps: int | None = None
        self.buckets: list[int] = []
        # Accepted from requests: None (60 steps) always; modes and
        # temperatures once warmed (no modes warmed = accept all).
        self.allowed_steps: set[int | None] = {None}
        self.allowed_modes: set[str] = set()
        self.allowed_temps: set[float] = {1.0}
        self.stats = {
            "requests": 0,
            "batches": 0,
            "largest_batch": 0,
            "last_batch_ms": 0.0,
            "max_batch_ms": 0.0,
            "slow_batches": 0,
        }
        self.slow_ms = 2000.0
        self._warming = False
        # The newest served batches' timeline in perf_counter() seconds: when
        # the batcher took the first request, when sampling started and
        # ended, and each request's submit time. For load tests in the same
        # process.
        self.batch_log: deque[dict] = deque(maxlen=4096)

        self._queue: deque[_Pending] = deque()
        self._cv = threading.Condition()
        self._draining = False  # True: refuse new requests (503)
        self._stopped = False  # True: batcher thread exits when idle
        self._inflight = 0  # groups inside _serve_group
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self._batcher.start()

    @classmethod
    def from_experiment(
        cls,
        experiment_path: str,
        source: str | None = None,
        max_batch: int = 16,
        batch_window_ms: float = 5.0,
        device: str | torch.device = "cuda",
    ):
        """A service for a run dir: its newest checkpoint in float32 (EMA
        weights where present), a style bank from `source`'s comma-separated
        PNGs through the config's style_weights (else the zero style), and
        the halved schedule for a distilled student."""
        from dhg_torch.checkpoint import resolve_checkpoint
        from dhg_torch.config import DLConfig
        from dhg_torch.models.denoiser import DiffusionModel

        exp = Path(experiment_path)
        ckpt = resolve_checkpoint(exp)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {experiment_path}")
        dev = resolve_device(device)
        model = DiffusionModel.load(ckpt, dtype=None, use_ema=True, device=dev)
        cfg = DLConfig.load(exp / "config.yml")
        if source:
            from dhg_torch.inference import style_from_image

            paths = [s.strip() for s in str(source).split(",") if s.strip()]
            style = torch.cat([
                style_from_image(p, style_weights=cfg.dataset_args.style_weights, device=dev)
                for p in paths
            ])
        else:
            style = torch.zeros((1, 14, 1280))
        service = cls(model, style, max_batch=max_batch, batch_window_ms=batch_window_ms,
                      device=dev)
        if cfg.training_args.distilled_steps:
            service.schedule = "halved"
            service.distilled_steps = int(cfg.training_args.distilled_steps)
        return service

    # -- bucketing ----------------------------------------------------------

    def bucket_for(self, n_tokens: int) -> int:
        """The smallest warmed bucket covering the prompt. A longer prompt
        clamps to the largest warmed bucket (the model is length-agnostic;
        the output is capped there) so that no live request captures; the
        exact length only while nothing is warmed."""
        exact = infer_seq_len(n_tokens)
        for b in sorted(self.buckets):
            if b >= exact:
                return b
        return max(self.buckets) if self.buckets else exact

    def _pad_batch_size(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return n

    def warmup(self, buckets: list[int], modes: tuple[str, ...] = ("new", "standard"),
               guided: bool = False, steps: tuple[int, ...] = (),
               temps: tuple[float, ...] = ()) -> None:
        """Capture every (bucket, padded batch size, mode) sampler graph, so
        no live request of a warmed variant pays a capture. Warm-up runs
        through the batcher queue, as live requests do: capture and replay
        then happen on the batcher thread. guided adds the one guided graph
        per combination (the scale is a device buffer); steps and temps add
        n_steps values and temperatures to warm and accept (1.0 and 60
        steps always). Afterwards the request stats restart from zero."""
        scales = [None] + ([2.0] if guided else [])
        steps_values = [None] + sorted({int(s) for s in steps} - {N_STEPS})
        temp_values = [1.0] + sorted({float(t) for t in temps} - {1.0})
        self._warming = True
        try:
            for seq_len in buckets:
                for mode in modes:
                    for g in scales:
                        for k in steps_values:
                            for tau in temp_values:
                                for b in self.batch_sizes:
                                    group = [
                                        _Pending([3, 1], i, mode, g, seq_len,
                                                 n_steps=k, temperature=tau,
                                                 t_submit=time.perf_counter())
                                        for i in range(b)
                                    ]
                                    with self._cv:
                                        self._queue.extend(group)
                                        self._cv.notify_all()
                                    for p in group:
                                        p.done.wait()
                                        if p.error is not None:
                                            raise p.error
                self.buckets.append(seq_len)
            self.allowed_steps.update(steps_values)
            self.allowed_modes.update(modes)
            self.allowed_temps.update(temp_values)
        finally:
            self._warming = False
        with self._cv:  # warm-up traffic is not serving traffic
            self.stats.update(requests=0, batches=0, largest_batch=0, last_batch_ms=0.0,
                              max_batch_ms=0.0, slow_batches=0)

    # -- one batch ---------------------------------------------------------------

    def _style_rows(self, style_ws, n: int, b: int) -> torch.Tensor:
        """[b, 14, 1280] styles for the batch: entry 0 broadcast when every
        row takes the default, else one product of a [b, S] weight matrix
        with the bank (padding rows take entry 0)."""
        if style_ws is None or all(w is None for w in style_ws):
            return self.styles[:1].expand(b, *self.styles.shape[1:])
        default_w = (1.0,) + (0.0,) * (self.n_styles - 1)
        wmat = np.asarray([(style_ws[i] if i < n and style_ws[i] is not None else default_w)
                           for i in range(b)], dtype=np.float32)
        return torch.einsum("bs,shw->bhw", torch.from_numpy(wmat).to(self.device),
                            self.styles)

    def _run_bucket(self, token_lists, seeds, seq_len, mode, guidance,
                    n_steps=None, temperature=1.0, style_ws=None) -> np.ndarray:
        """One sampler batch for a group of requests sharing a bucket: a
        graph replay on CUDA, one eager `generate` on the CPU. Padding rows
        take seed 0, bank entry 0 and zero text."""
        from dhg_torch.inference import generate

        n = len(token_lists)
        b = self._pad_batch_size(n)
        text = np.zeros((b, self.max_text_len), np.int64)
        for i, toks in enumerate(token_lists):
            text[i, : len(toks)] = toks
        row_seeds = [seeds[i] if i < n else 0 for i in range(b)]
        with torch.inference_mode():
            style = self._style_rows(style_ws, n, b)
            if self.graphs is None:
                out = generate(self.model, text, style, seq_len=seq_len, diffusion_mode=mode,
                               guidance_scale=guidance, n_steps=n_steps,
                               schedule=self.schedule, temperature=temperature,
                               device=self.device, sample_seeds=row_seeds).numpy()
            else:
                x_init, noises = per_sample_noise_streams(row_seeds, n_steps or N_STEPS,
                                                          seq_len, self.device)
                out = self.graphs.run(torch.from_numpy(text).to(self.device), style, x_init,
                                      noises, seq_len, mode, guidance, n_steps,
                                      self.schedule, temperature)
        return out[:n]

    # -- the batcher thread ---------------------------------------------------

    def _batch_loop(self):
        while True:
            with self._cv:
                while not self._queue:
                    if self._stopped:
                        return
                    self._cv.wait()
                first = self._queue.popleft()
                self._inflight += 1
            taken = time.perf_counter()
            group = [first]
            deadline = time.perf_counter() + self.batch_window
            while len(group) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                with self._cv:
                    take = [p for p in self._queue
                            if p.group_key() == first.group_key()][: self.max_batch - len(group)]
                    for p in take:
                        self._queue.remove(p)
                    if not take:
                        self._cv.wait(timeout=remaining)
                group.extend(take)
            self._serve_group(group, taken)

    def _serve_group(self, group: list[_Pending], taken: float):
        """Sample one group and hand each request its rows; `taken` is when
        the batcher took the group's first request (for batch_log)."""
        try:
            bucket = group[0].bucket
            t0 = time.perf_counter()
            out = self._run_bucket(
                [p.tokens for p in group],
                [p.seed for p in group],
                bucket,
                group[0].mode,
                group[0].guidance,
                n_steps=group[0].n_steps,
                temperature=group[0].temperature,
                style_ws=[p.style_w for p in group],
            )
            t1 = time.perf_counter()
            ms = (t1 - t0) * 1000
            if ms > self.slow_ms and not self._warming:
                logging.getLogger(__name__).warning(
                    "slow batch: n=%d bucket=%d mode=%s took %.0f ms",
                    len(group), bucket, group[0].mode, ms,
                )
            with self._cv:  # /healthz reads stats from request threads
                self.stats["batches"] += 1
                self.stats["largest_batch"] = max(self.stats["largest_batch"], len(group))
                self.stats["last_batch_ms"] = round(ms, 1)
                self.stats["max_batch_ms"] = max(self.stats["max_batch_ms"], round(ms, 1))
                self.stats["slow_batches"] += ms > self.slow_ms
            # Logged before any result is released, so a client that has its
            # answer finds its batch in the log.
            self.batch_log.append({"taken": taken, "start": t0, "end": t1,
                                   "submits": [p.t_submit for p in group]})
            for i, p in enumerate(group):
                p.seq_len = bucket
                p.result = out[i, : infer_seq_len(len(p.tokens))]
                p.done.set()
        except Exception as e:  # the batch's requests get the error (HTTP 500)
            logging.getLogger(__name__).exception("batch of %d failed", len(group))
            for p in group:
                p.error = e
                p.done.set()
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()  # shutdown() waits on queue + inflight

    def shutdown(self, timeout: float = 60.0) -> None:
        """Graceful drain: refuse new requests (Draining -> HTTP 503), wait
        for every queued and in-flight request, then stop the batcher
        thread. Idempotent; safe from any thread. Requests still waiting at
        `timeout` keep running on the daemon batcher, but the caller stops
        waiting for them."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._draining = True
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    logging.getLogger(__name__).warning(
                        "shutdown drain timed out with %d queued / %d in flight",
                        len(self._queue), self._inflight,
                    )
                    break
                self._cv.wait(timeout=remaining)
            self._stopped = True
            self._cv.notify_all()
        self._batcher.join(timeout=5.0)

    def stats_snapshot(self) -> dict:
        """A consistent copy of the stats (all writes happen under self._cv),
        with "captures": the graphs captured so far (0 on the CPU; warmup
        does not reset it)."""
        with self._cv:
            captures = 0 if self.graphs is None else self.graphs.captures
            return dict(self.stats, captures=captures)

    # -- request API ----------------------------------------------------------

    def _parse_style(self, style) -> tuple[float, ...] | None:
        """A request's style field checked against the bank: None -> entry 0,
        an int -> that entry, a list of floats (one per entry) -> a blend.
        Raises ValueError (HTTP 400) otherwise."""
        n_bank = self.n_styles
        if style is None:
            return None
        if isinstance(style, bool):
            raise ValueError("style must be an int index or a list of weights")
        if isinstance(style, int):
            if not 0 <= style < n_bank:
                raise ValueError(
                    f"style index {style} out of range (bank has {n_bank} "
                    "entries; load more via --source=a.png,b.png,...)"
                )
            return tuple(1.0 if i == style else 0.0 for i in range(n_bank))
        if isinstance(style, (list, tuple)):
            if len(style) != n_bank:
                raise ValueError(
                    f"style weights must have one entry per bank style "
                    f"({n_bank}), got {len(style)}"
                )
            try:
                w = tuple(float(x) for x in style)
            except (TypeError, ValueError):
                raise ValueError("style weights must be numbers") from None
            if not all(np.isfinite(w)):
                raise ValueError("style weights must be finite")
            return w
        raise ValueError("style must be an int index or a list of weights")

    def _make_pending(self, prompt: str, seed: int, diffusion_mode: str | None,
                      guidance_scale: float | None, n_steps: int | None,
                      temperature: float | None, style) -> tuple[_Pending, bool]:
        """Check one line request and build its queue entry (not submitted).
        Returns (pending, truncated): truncated when the prompt exceeds
        every warmed bucket and its output is capped at the largest."""
        # A distilled student's defaults (as infer's): its halved grid, DDIM.
        if diffusion_mode is None:
            diffusion_mode = "ddim" if self.distilled_steps else "new"
        if n_steps is None and self.distilled_steps:
            n_steps = self.distilled_steps
        tokens = self.tokenizer.encode(prompt)
        if len(tokens) > self.max_text_len:
            raise ValueError(f"prompt too long ({len(tokens)} tokens > {self.max_text_len})")
        if self.allowed_modes and diffusion_mode not in self.allowed_modes:
            raise ValueError(
                f"diffusion_mode={diffusion_mode!r} not warmed (allowed: "
                f"{sorted(self.allowed_modes)}); start the server with "
                "--warm_modes to enable it"
            )
        if n_steps is not None:
            n_steps = int(n_steps)
            if n_steps == N_STEPS:
                n_steps = None  # the canonical schedule's graph
            elif n_steps not in self.allowed_steps:
                raise ValueError(
                    f"n_steps={n_steps} not warmed (allowed: "
                    f"{sorted(s for s in self.allowed_steps if s)} + {N_STEPS}); "
                    "start the server with --warm_steps to enable it"
                )
        temperature = 1.0 if temperature is None else float(temperature)
        if temperature != 1.0 and temperature not in self.allowed_temps:
            raise ValueError(
                f"temperature={temperature} not warmed (allowed: "
                f"{sorted(self.allowed_temps)}); start the server with "
                "--warm_temps to enable it"
            )
        style_w = self._parse_style(style)
        bucket = self.bucket_for(len(tokens))
        truncated = bucket < infer_seq_len(len(tokens))
        req = _Pending(tokens, seed, diffusion_mode, guidance_scale, bucket, n_steps,
                       temperature=temperature, style_w=style_w)
        return req, truncated

    def _submit(self, reqs: list[_Pending]) -> None:
        """Enqueue the pendings atomically (all, or 503) and wake the batcher."""
        with self._cv:
            if self._draining:
                raise Draining("server is draining; not accepting new requests")
            now = time.perf_counter()
            for p in reqs:
                p.t_submit = now
            self._queue.extend(reqs)
            self.stats["requests"] += 1
            self._cv.notify_all()

    def generate_line(self, prompt: str, seed: int = 0, diffusion_mode: str | None = None,
                      guidance_scale: float | None = None, n_steps: int | None = None,
                      temperature: float | None = None, style=None
                      ) -> tuple[np.ndarray, int, float, bool]:
        """One line: (strokes [T, 3], bucket, ms, truncated)."""
        req, truncated = self._make_pending(prompt, seed, diffusion_mode, guidance_scale,
                                            n_steps, temperature, style)
        t0 = time.perf_counter()
        self._submit([req])
        req.done.wait()
        if req.error is not None:
            raise req.error
        ms = (time.perf_counter() - t0) * 1000
        return req.result, req.seq_len, ms, truncated

    def generate_page(self, prompt: str, wrap: int, seed: int = 0,
                      line_gap: float | None = None, align: str = "left", **line_kwargs
                      ) -> tuple[np.ndarray, int, float, bool]:
        """A paragraph: word-wrap the prompt, sample every line through the
        same queue (line i with seed + i, so the page is reproducible from
        its base seed), compose one page. Returns (page_strokes,
        n_lines_sampled, ms, truncated_any)."""
        from dhg_torch.inference import wrap_text
        from dhg_torch.utils.vis import compose_lines

        if align not in ("left", "center"):
            raise ValueError(f"unknown align {align!r} (expected left or center)")
        if wrap + 1 > self.max_text_len:
            raise ValueError(
                f"wrap={wrap} + EOS exceeds max_text_len={self.max_text_len}; "
                f"use wrap <= {self.max_text_len - 1}"
            )
        wrapped = wrap_text(prompt, int(wrap))
        if not any(ln for ln in wrapped):
            raise ValueError("prompt has no printable content to wrap")
        if len(wrapped) > self.max_page_lines:
            raise ValueError(
                f"page too long ({len(wrapped)} wrapped lines > "
                f"max_page_lines={self.max_page_lines}); split the prompt "
                "into multiple requests"
            )
        reqs: list[_Pending | None] = []
        truncated = False
        for i, ln in enumerate(wrapped):
            if not ln:
                reqs.append(None)  # a blank line: a paragraph gap
                continue
            req, trunc = self._make_pending(
                ln, seed + i, line_kwargs.get("diffusion_mode"),
                line_kwargs.get("guidance_scale"), line_kwargs.get("n_steps"),
                line_kwargs.get("temperature"), line_kwargs.get("style"))
            truncated = truncated or trunc
            reqs.append(req)
        live = [r for r in reqs if r is not None]
        t0 = time.perf_counter()
        self._submit(live)
        for r in live:
            r.done.wait()
        errs = [r.error for r in live if r.error is not None]
        if errs:
            raise errs[0]
        page = compose_lines([None if r is None else r.result for r in reqs],
                             line_gap=line_gap, align=align)
        ms = (time.perf_counter() - t0) * 1000
        return page, len(live), ms, truncated


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(
                    200,
                    {"ok": True, "buckets": sorted(service.buckets),
                     "warm_steps": sorted(s for s in service.allowed_steps if s),
                     "warm_modes": sorted(service.allowed_modes),
                     "warm_temps": sorted(service.allowed_temps),
                     "styles": service.n_styles,
                     "stats": service.stats_snapshot()},
                )
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                prompt = req["prompt"]
                common = dict(
                    seed=int(req.get("seed", 0)),
                    diffusion_mode=req.get("diffusion_mode"),
                    guidance_scale=req.get("guidance_scale"),
                    n_steps=req.get("n_steps"),
                    temperature=req.get("temperature"),
                    style=req.get("style"),
                )
                if req.get("wrap") is not None:
                    page, n_lines, ms, truncated = service.generate_page(
                        prompt, wrap=int(req["wrap"]), line_gap=req.get("line_gap"),
                        align=req.get("align", "left"), **common,
                    )
                    self._send(200, {"strokes": np.round(page, 5).tolist(), "lines": n_lines,
                                     "ms": round(ms, 2), "truncated": truncated})
                    return
                strokes, seq_len, ms, truncated = service.generate_line(prompt, **common)
                self._send(200, {"strokes": np.round(strokes, 5).tolist(), "seq_len": seq_len,
                                 "ms": round(ms, 2), "truncated": truncated})
            except Draining as e:
                self._send(503, {"error": str(e)})
            except (KeyError, ValueError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet; the service logs its own
            pass

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog (5) drops connections in a burst
    # of concurrent clients; a batching server expects bursts.
    request_queue_size = 512


def serve(service: GenerationService, port: int = 8008, warmup_buckets=(200, 400),
          warmup_modes: tuple[str, ...] = ("new", "standard"), warmup_guided: bool = False,
          warm_steps: tuple[int, ...] = (), warm_temps: tuple[float, ...] = ()):
    """Warm the service, then return its HTTP server (not yet serving)."""
    service.warmup(list(warmup_buckets), modes=warmup_modes, guided=warmup_guided,
                   steps=warm_steps, temps=warm_temps)
    return _Server(("127.0.0.1", port), make_handler(service))


def _csv(kw: dict, name: str, default: str, kind) -> tuple:
    """A comma-separated CLI list; an empty value (--name=) is empty."""
    raw = kw.get(name, default)
    raw = "" if raw is None else str(raw)
    return tuple(kind(v.strip()) for v in raw.split(",") if v.strip())


def main(argv=None):
    import signal
    import sys

    from dhg_torch.config import parse_cli_kwargs

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    service = GenerationService.from_experiment(
        kw["experiment_path"],
        source=kw.get("source"),
        max_batch=int(kw.get("max_batch", 16)),
        batch_window_ms=float(kw.get("batch_window_ms", 5.0)),
        device=str(kw.get("device", "cuda")),
    )
    # "--warmup_buckets=" skips warm-up (a smoke path).
    buckets = list(_csv(kw, "warmup_buckets", "200,400", int))
    warm_steps = _csv(kw, "warm_steps", "", int)
    warm_modes = _csv(kw, "warm_modes", "new,standard", str)
    warm_temps = _csv(kw, "warm_temps", "", float)
    if service.distilled_steps:
        # A student's defaults (its halved grid, DDIM) never capture live.
        if service.distilled_steps not in warm_steps:
            warm_steps = warm_steps + (service.distilled_steps,)
        if "ddim" not in warm_modes:
            warm_modes = warm_modes + ("ddim",)
    httpd = serve(service, port=int(kw.get("port", 8008)), warmup_buckets=buckets,
                  warmup_modes=warm_modes, warm_steps=warm_steps, warm_temps=warm_temps)
    print(f"dhg_torch serving on 127.0.0.1:{httpd.server_address[1]} (buckets {buckets})",
          flush=True)

    # SIGTERM (preemption) and SIGINT drain. The handler runs on the main
    # thread under serve_forever, and httpd.shutdown() waits for
    # serve_forever to return, so it runs on a helper thread. Installed
    # explicitly: a detached process inherits SIGINT ignored.
    def _stop(signum, frame):
        logging.getLogger(__name__).info("signal %d: draining...", signum)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _stop)
        except ValueError:  # not the main thread (embedded use)
            break
    httpd.serve_forever()
    service.shutdown()
    httpd.server_close()
    print("dhg_torch server stopped (drained)", flush=True)


if __name__ == "__main__":
    main()
