"""The sampler as captured CUDA graphs: the port's counterpart of the
compile cache of dhg's `_sample_jit` (dhg/inference.py), where the whole
reverse-diffusion loop is one XLA program per static signature.

`SamplerGraphs` holds one `torch.cuda.CUDAGraph` per key (padded batch,
seq_len, mode, guided or not, n_steps, schedule, temperature): dhg's jit
key. The guidance scale is a 0-d device buffer, as dhg traces it, so one
guided graph serves every scale. Each graph reads static input buffers
(text [b, L] int64, style [b, 14, 1280], x_init [b, T, 2], noises
[n, b, T, 2], the guidance scalar) and writes one static output
[b, T, 3]; `run` copies a request's tensors in, replays, and copies the
output to the host before it returns.

A key's graph is captured on first use from `dhg_torch.inference._sample`,
the body of `generate` after its host-side preparation, after one eager
call on the same buffers: that call builds every lazily made cache (the
beta table, the models' cast caches, cuBLAS handles) outside the capture,
so nothing cached is first allocated inside a graph's pool. Randomness is
always pre-drawn (per_sample_noise_streams), never drawn inside a graph.

Memory: all of a cache's graphs share one private pool and are replayed
one at a time. A graph's temporaries may then lie where another graph's
output lies, so `run` copies each output off the card before the next
replay; callers must not replay two graphs at once (the serving runtime
replays on its one batcher thread). Capture uses
capture_error_mode="thread_local": other threads may run CUDA work
meanwhile, as long as it is not on the capturing thread.

CUDA only: on the CPU there is no graph, and callers run `generate`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dhg_torch import resolve_device
from dhg_torch.core.schedule import N_STEPS
from dhg_torch.inference import _check_model_device, _sample, beta_table


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    text: torch.Tensor
    style: torch.Tensor
    x_init: torch.Tensor
    noises: torch.Tensor
    guidance: torch.Tensor
    out: torch.Tensor


class SamplerGraphs:
    """One captured sampler graph per key for `model`, replayed by `run`."""

    def __init__(self, model, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        _check_model_device(model, self.device)
        self.model = model
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: dict[tuple, _Graph] = {}

    @property
    def captures(self) -> int:
        """Graphs captured so far (none is ever dropped)."""
        return len(self._graphs)

    @staticmethod
    def key(batch: int, seq_len: int, mode: str = "new", guidance_scale=None,
            n_steps: int | None = None, schedule: str = "strided",
            temperature: float | None = None) -> tuple:
        """The cache key, normalised as `generate` normalises its arguments:
        guidance 1 is unguided, n_steps 60 the canonical table, temperature
        None is 1."""
        guided = guidance_scale is not None and float(guidance_scale) != 1.0
        n_steps = None if n_steps is None or int(n_steps) == N_STEPS else int(n_steps)
        temperature = 1.0 if temperature is None else float(temperature)
        return (int(batch), int(seq_len), mode, guided, n_steps, schedule, temperature)

    def __contains__(self, key: tuple) -> bool:
        return key in self._graphs

    def run(self, text: torch.Tensor, style: torch.Tensor, x_init: torch.Tensor,
            noises: torch.Tensor, seq_len: int, mode: str = "new", guidance_scale=None,
            n_steps: int | None = None, schedule: str = "strided",
            temperature: float | None = None) -> np.ndarray:
        """Strokes [b, seq_len, 3] (float32, on the host) for device inputs
        text [b, L], style [b, 14, 1280], x_init [b, T, 2] and noises
        [n, b, T, 2], by replaying the key's graph (captured first if it is
        new). The same inputs give the same bits as `generate` with them."""
        key = self.key(text.shape[0], seq_len, mode, guidance_scale, n_steps, schedule,
                       temperature)
        if key[6] <= 0.0:
            raise ValueError(f"temperature must be > 0, got {key[6]}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            entry = self._graphs.get(key)
            fresh = entry is None
            if fresh:
                entry = self._buffers(text, style, x_init, noises)
            entry.text.copy_(text)
            entry.style.copy_(style)
            entry.x_init.copy_(x_init)
            entry.noises.copy_(noises)
            entry.guidance.fill_(1.0 if guidance_scale is None else float(guidance_scale))
            if fresh:
                self._capture(key, entry)
                self._graphs[key] = entry
            entry.graph.replay()
            return entry.out.cpu().numpy()

    def _buffers(self, text, style, x_init, noises) -> _Graph:
        dev = self.device

        def like(t, dtype):
            return torch.empty(t.shape, dtype=dtype, device=dev)

        return _Graph(torch.cuda.CUDAGraph(), like(text, torch.long),
                      like(style, torch.float32), like(x_init, torch.float32),
                      like(noises, torch.float32),
                      torch.ones((), dtype=torch.float32, device=dev), None)

    def _capture(self, key: tuple, entry: _Graph) -> None:
        _, seq_len, mode, guided, n_steps, schedule, temperature = key
        beta_set = beta_table(N_STEPS if n_steps is None else n_steps, schedule,
                              str(self.device))
        if beta_set.shape[0] != entry.noises.shape[0]:
            raise ValueError(f"{entry.noises.shape[0]} noise draws for {beta_set.shape[0]} steps")

        def body():
            return _sample(self.model, entry.text, entry.style, None, seq_len, beta_set, mode,
                           entry.guidance if guided else None, temperature, entry.x_init,
                           entry.noises, self.device)

        body()  # eager: builds the caches outside the capture
        with torch.cuda.graph(entry.graph, pool=self.pool, capture_error_mode="thread_local"):
            entry.out = body()
