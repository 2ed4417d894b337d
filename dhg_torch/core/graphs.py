"""The sampler as captured CUDA graphs: the port's counterpart of dhg's
`_sample_jit` (dhg/inference.py), where the whole reverse-diffusion loop
is one XLA program per static signature.

`SamplerGraphs` holds one `torch.cuda.CUDAGraph` of
`dhg_torch.inference._sample` (the body of `generate` after its host-side
preparation) per `SamplerKey`: dhg's static arguments (padded batch,
seq_len, mode, guided or not, n_steps and schedule, temperature, hoist,
encoder_reuse), the text's width, and the kernel modes
(kernels/runtime.py::kernel_modes), which the traced path reads from the
environment and a graph bakes in. The guidance scale is a 0-d device
buffer, as dhg traces it, so one guided graph serves every scale. Each
graph reads static input buffers (text [b, L] int64, style [b, 14, 1280],
x_init [b, T, 2], noises [n, b, T, 2], the guidance scalar) and writes one
static output [b, T, 3]. Randomness is always pre-drawn
(core/sampling.py::sampler_draws, per_sample_noise_streams), never drawn
inside a graph.

Two front ends share it. `generate` keeps one instance a model
(inference.py::sampler_graphs) and calls `sample`: a key's first call runs
`_sample` eagerly (the warm-up a capture needs; a one-shot call pays no
capture), the second captures the key's graph and replays it, later calls
replay. The serving runtime keeps its own instance and calls `run`, which
captures on a key's first use, after one eager call on the same buffers,
and returns the output on the host.

A capture starts and ends with the model's cast caches empty
(ops/basic.py::clear_cast_caches), so the weights' bf16 casts and the
kernels' weight tiles are made inside the graph: every replay reads the
parameters as they are then (an in-place update is seen), and no eager
call keeps a tensor of the graph's pool. An entry also keeps the
parameters' storage (data_ptr) and the model's training flag at capture;
a call that finds them changed (weights replaced, `.to()`) captures again.
The kernel launches a capture records are taken back from the wrappers'
counts and added at every replay (kernels/runtime.py::add_launches).

Memory: all of an instance's graphs share one private pool and are
replayed one at a time, under the instance's lock. A graph's temporaries
may lie where another graph's output lies, so each call hands back a copy
of the output taken right after its replay. Every capture goes through
`capture`: capture_error_mode="thread_local" (other threads may run CUDA
work meanwhile, as long as it is not on the capturing thread), with
Python's cyclic garbage collected before and the collector held off until
it ends. A failed capture raises; nothing falls back to the eager path.

CUDA only: on the CPU there is no graph, and `generate` runs `_sample`.

The capture itself is shared with the port's other graphs.
`capture_counted` is one capture of a body with its modules' cast caches
empty before and after and its launch counts taken back; `SamplerGraphs`
and `CapturedBody` both go through it. `CapturedBody` is one body on its
static inputs, taken eagerly on a side stream at its first call (so that
what a first call makes lazily, the kernel library, cuBLAS's handles and
workspaces, autograd's state, is made outside the capture), then captured
and replayed with no fallback: the train step and its forward
(train.py::StepGraph), the distill step (distill.py::Distiller.make_step_fn)
and the style trunk's step (tools/train_style_trunk.py::TrunkStep).
`KeyedGraphs` keeps one CapturedBody per key in one pool, as a jitted
function keeps one program per static signature: the eval step
(eval.py::EvalGraphs), the StyleExtractor's apply_fn
(models/style_extractor.py::make_apply_fn) and the Jacobi sampler a sweep
count (tools/eval_parallel_sampler.py).
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from dhg_torch import resolve_device
from dhg_torch.core.schedule import N_STEPS
from dhg_torch.inference import _check_model_device, _sample, beta_table
from dhg_torch.kernels.runtime import add_launches, kernel_modes, launch_counts
from dhg_torch.ops.basic import clear_cast_caches


@contextmanager
def capture(graph: torch.cuda.CUDAGraph, pool=None):
    """torch.cuda.graph(graph, pool, capture_error_mode="thread_local"),
    with the cyclic garbage collected first and no collection until the
    capture ends. A collection inside the capture (automatic, on any thread
    that runs Python, autograd's included) may free a CUDAGraph that only a
    collection can free, such as a stopped server's, whose handler class
    refers to it: destroying a graph while another is being captured is
    not permitted (PyTorch only warns), and the capture ends in
    cudaErrorStreamCaptureInvalidated."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


def storage_state(model) -> tuple:
    """`model`'s parameter and buffer storage (data_ptr) and its training
    flag: a graph captured on other storage reads the old weights, and one
    captured in the other mode runs the other path."""
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers())) + (model.training,)


def capture_counted(graph: torch.cuda.CUDAGraph, body, modules, pool=None):
    """`body()` captured into `graph` through `capture`, with the cast caches
    of `modules` dropped before and after: the casts a no-grad forward
    caches are then made inside the graph, from the parameters as they are
    at each replay, and no eager call later reads a cast that lives in the
    graph's pool. The capture launches nothing, so the launch counts the
    kernel wrappers took while it ran are taken back. Returns (body's
    output, the kernel launches a replay makes, host seconds)."""
    for m in modules:
        clear_cast_caches(m)
    before, t0 = launch_counts(), time.perf_counter()
    try:
        with capture(graph, pool):
            out = body()
    finally:
        for m in modules:
            clear_cast_caches(m)  # casts the capture cached live in the graph's pool
        launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        add_launches({k: -v for k, v in launches.items()})
    return out, launches, time.perf_counter() - t0


class CapturedBody:
    """`body(*inputs)` as one CUDA graph on static inputs, which the caller
    refills in place before each `run`. The first `run` takes the body
    eagerly on a side stream and returns its result, then captures it
    (capture_counted, over `modules`' cast caches, into `pool`: a private
    one by default); every later `run` replays the graph, adds the launches
    it makes (kernels/runtime.py::add_launches) and returns its static
    output, which the next replay of a graph of the same pool overwrites. A
    failed capture or replay raises: nothing falls back to the eager body."""

    def __init__(self, body, inputs: tuple, modules, device: str | torch.device = "cuda",
                 pool=None):
        self.body, self.inputs = body, tuple(inputs)
        self.modules, self.device, self.pool = tuple(modules), torch.device(device), pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None  # the graph's static output
        self.launches: dict[str, int] = {}  # kernel launches a replay makes
        self.capture_s: float | None = None  # host seconds of the capture

    def run(self):
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        add_launches(self.launches)
        return self.out

    def _warm_up_and_capture(self):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = self.body(*self.inputs)
        current.wait_stream(side)
        if isinstance(first, torch.Tensor):
            first.record_stream(current)  # the caller reads it on `current`
        graph = torch.cuda.CUDAGraph()
        self.out, self.launches, self.capture_s = capture_counted(
            graph, lambda: self.body(*self.inputs), self.modules, self.pool)
        self.graph = graph
        return first


class KeyedGraphs:
    """`body(key, *inputs)` of `model` as one CapturedBody per key, all in
    one memory pool: the port's counterpart of a jitted function's cache of
    compiled programs, one a static signature. `run(key, *inputs)` copies
    the inputs into the key's static buffers and replays its graph; a key
    with no graph is captured on its first call (the body taken eagerly on
    a side stream, then captured), or, with eager_first, runs the body
    eagerly on its first call and is captured on its second, so a one-shot
    call pays no capture (generate's rule). Each entry keeps the model's
    storage at its capture (storage_state): a call that finds it replaced
    (a new load, `.to()`, a mode switch) captures again, while an in-place
    update is read. A graph's temporaries may lie where another graph's
    output lies, so each call returns a copy of the output. CUDA only; a
    failed capture or replay raises."""

    def __init__(self, model, body, eager_first: bool = False):
        self.model, self.body, self.eager_first = model, body, eager_first
        self.device = next(model.parameters()).device
        self.pool = torch.cuda.graph_pool_handle()
        self.captures = 0  # graphs captured so far, captures again included
        self.graphs: dict = {}  # key -> (CapturedBody, the model's storage_state at capture)
        self.seen: set = set()  # keys run eagerly (eager_first)

    def run(self, key, *inputs: torch.Tensor):
        state = storage_state(self.model)
        entry = self.graphs.get(key)
        if entry is not None and entry[1] == state:
            for buf, v in zip(entry[0].inputs, inputs):
                buf.copy_(v)
            return entry[0].run().clone()
        if self.eager_first and key not in self.seen:
            self.seen.add(key)
            return self.body(key, *inputs)
        graph = CapturedBody(lambda *xs: self.body(key, *xs), tuple(v.clone() for v in inputs),
                             (self.model,), self.device, self.pool)
        out = graph.run()
        self.graphs[key] = (graph, state)
        self.captures += 1
        return out


class SamplerKey(NamedTuple):
    """One graph's static arguments, normalised as `generate` normalises
    them (SamplerGraphs.key)."""

    batch: int
    seq_len: int
    text_len: int
    mode: str
    guided: bool
    n_steps: int | None  # None: the canonical 60-level table
    schedule: str | None  # None with the canonical table
    temperature: float
    hoist: str
    encoder_reuse: int | None
    kernels: tuple  # kernels/runtime.py::kernel_modes


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    text: torch.Tensor
    style: torch.Tensor
    x_init: torch.Tensor
    noises: torch.Tensor
    guidance: torch.Tensor
    state: tuple  # the model's parameter storage and training flag at capture
    out: torch.Tensor | None = None
    launches: dict = field(default_factory=dict)  # kernel launches a replay makes
    capture_s: float = 0.0  # host seconds of the capture


class SamplerGraphs:
    """Captured sampler graphs of `model` (held weakly), one per key."""

    def __init__(self, model, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        _check_model_device(model, self.device)
        self._model = weakref.ref(model)
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()  # two replays of one pool must not overlap
        self.captures = 0  # graphs captured so far, captures again included
        self._graphs: dict[SamplerKey, _Graph] = {}
        self._seen: set[SamplerKey] = set()  # keys `sample` has run eagerly

    @property
    def model(self):
        model = self._model()
        if model is None:
            raise RuntimeError("the model of these sampler graphs is gone")
        return model

    @staticmethod
    def key(batch: int, seq_len: int, mode: str = "new", guidance_scale=None,
            n_steps: int | None = None, schedule: str = "strided",
            temperature: float | None = None, hoist: str | None = None,
            encoder_reuse: int | None = None, text_len: int = 50,
            device: str | torch.device = "cuda") -> SamplerKey:
        """The cache key, normalised as `generate` normalises its arguments:
        guidance 1 is unguided, n_steps 60 the canonical table (whatever
        the schedule), temperature None is 1, an unknown mode is "new",
        hoist None is "compact", encoder_reuse <= 1 is none (and reuse
        runs on the full hoist). The kernel modes are read now, for
        `device`."""
        guided = guidance_scale is not None and float(guidance_scale) != 1.0
        n_steps = None if n_steps is None or int(n_steps) == N_STEPS else int(n_steps)
        reuse = int(encoder_reuse) if encoder_reuse is not None and encoder_reuse > 1 else None
        return SamplerKey(
            int(batch), int(seq_len), int(text_len),
            mode if mode in ("standard", "ddim") else "new", guided, n_steps,
            None if n_steps is None else schedule,
            1.0 if temperature is None else float(temperature),
            "full" if reuse else ("compact" if hoist is None else hoist), reuse,
            kernel_modes(torch.device(device)))

    def __contains__(self, key: SamplerKey) -> bool:
        return key in self._graphs

    def info(self, key: SamplerKey) -> dict | None:
        """The key's capture: its host seconds and the kernel launches each
        replay makes; None if the key has no graph."""
        entry = self._graphs.get(key)
        if entry is None:
            return None
        return {"capture_s": entry.capture_s, "launches": dict(entry.launches)}

    def sample(self, text: torch.Tensor, style: torch.Tensor, x_init: torch.Tensor,
               noises: torch.Tensor, seq_len: int, mode: str = "new", guidance_scale=None,
               n_steps: int | None = None, schedule: str = "strided",
               temperature: float | None = None, hoist: str | None = None,
               encoder_reuse: int | None = None) -> torch.Tensor:
        """`generate`'s body on the card: strokes [b, seq_len, 3] (float32,
        a device tensor of the caller's) for device inputs text [b, L],
        style [b, 14, 1280], x_init [b, T, 2] and noises [n, b, T, 2]. The
        key's first call runs `_sample` eagerly; the second captures the
        graph and replays it; later calls replay. Every call gives the bits
        of `_sample` on the same inputs."""
        key = self.key(text.shape[0], seq_len, mode, guidance_scale, n_steps, schedule,
                       temperature, hoist, encoder_reuse, text.shape[1], self.device)
        with self.lock, torch.inference_mode():
            if key not in self._seen:
                out = _sample(self.model, text, style, None, seq_len, self._beta(key), mode,
                              guidance_scale, key.temperature, x_init, noises, self.device,
                              key.hoist, key.encoder_reuse)
                self._seen.add(key)
                return out
            return self._replay(key, text, style, x_init, noises, guidance_scale,
                                warm_up=False).out.clone()

    def run(self, text: torch.Tensor, style: torch.Tensor, x_init: torch.Tensor,
            noises: torch.Tensor, seq_len: int, mode: str = "new", guidance_scale=None,
            n_steps: int | None = None, schedule: str = "strided",
            temperature: float | None = None) -> np.ndarray:
        """Strokes [b, seq_len, 3] (float32, on the host) for device inputs
        as `sample`'s, by replaying the key's graph, captured first (after
        one eager call on its buffers) if the key is new. The same inputs
        give the same bits as `generate` with them."""
        key = self.key(text.shape[0], seq_len, mode, guidance_scale, n_steps, schedule,
                       temperature, text_len=text.shape[1], device=self.device)
        if key.temperature <= 0.0:
            raise ValueError(f"temperature must be > 0, got {key.temperature}")
        with self.lock, torch.inference_mode():
            return self._replay(key, text, style, x_init, noises, guidance_scale,
                                warm_up=True).out.cpu().numpy()

    def _beta(self, key: SamplerKey) -> torch.Tensor:
        return beta_table(N_STEPS if key.n_steps is None else key.n_steps,
                          key.schedule or "strided", str(self.device))

    def _replay(self, key, text, style, x_init, noises, guidance_scale, warm_up) -> _Graph:
        """The key's graph, replayed on these inputs (captured first if the
        key is new or the model's parameters moved). The lock is held."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        n = self._beta(key).shape[0]
        if noises.shape[0] != n:
            raise ValueError(f"{noises.shape[0]} noise draws for {n} steps")
        state = storage_state(self.model)
        entry = self._graphs.get(key)
        if entry is not None and entry.state != state:
            del self._graphs[key]  # the weights moved: this graph reads the old ones
            entry = None
        fresh = entry is None
        if fresh:
            entry = self._buffers(key, style, n, state)
        entry.text.copy_(text)
        entry.style.copy_(style)
        entry.x_init.copy_(x_init)
        entry.noises.copy_(noises)
        entry.guidance.fill_(1.0 if guidance_scale is None else float(guidance_scale))
        if fresh:
            self._capture(key, entry, warm_up)
            self._graphs[key] = entry
        entry.graph.replay()
        add_launches(entry.launches)
        return entry

    def _buffers(self, key: SamplerKey, style: torch.Tensor, n: int, state: tuple) -> _Graph:
        b, t, dev = key.batch, key.seq_len, self.device
        return _Graph(torch.cuda.CUDAGraph(),
                      torch.empty((b, key.text_len), dtype=torch.long, device=dev),
                      torch.empty((b,) + tuple(style.shape[1:]), device=dev),
                      torch.empty((b, t, 2), device=dev), torch.empty((n, b, t, 2), device=dev),
                      torch.ones((), device=dev), state)

    def _capture(self, key: SamplerKey, entry: _Graph, warm_up: bool) -> None:
        model, beta_set = self.model, self._beta(key)

        def body():
            return _sample(model, entry.text, entry.style, None, key.seq_len, beta_set,
                           key.mode, entry.guidance if key.guided else None, key.temperature,
                           entry.x_init, entry.noises, self.device, key.hoist,
                           key.encoder_reuse)

        if warm_up:
            body()  # eager: builds what is made lazily outside the capture
        entry.out, entry.launches, entry.capture_s = capture_counted(entry.graph, body, (model,),
                                                                     self.pool)
        self.captures += 1
