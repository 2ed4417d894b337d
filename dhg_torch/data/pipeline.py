"""Device-resident batches for training (port of dhg/data/pipeline.py).

The whole packed cache is uploaded once; each step gathers a random batch by
index on the device, so a step moves no data from the host. Randomness comes
from a torch.Generator on the cache's device, or from pre-drawn tensors (the
parity tests hand both packages the same numpy draws).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class IAMCache:
    """Packed dataset arrays (the port's copy of dhg.data.iam.IAMCache)."""

    strokes: np.ndarray  # f32 [N, max_seq_len, 3]
    text: np.ndarray  # i32 [N, max_text_len]
    style: np.ndarray  # f32 [N, 14, 1280]
    sample_ids: list[str]

    def __len__(self) -> int:
        return len(self.sample_ids)

    def save(self, path) -> None:
        """An .npz with dhg's keys, so either package loads the other's."""
        np.savez_compressed(path, strokes=self.strokes, text=self.text, style=self.style,
                            sample_ids=np.array(self.sample_ids))

    @classmethod
    def load(cls, path) -> "IAMCache":
        with np.load(path, allow_pickle=False) as z:
            return cls(strokes=z["strokes"], text=z["text"], style=z["style"],
                       sample_ids=[str(s) for s in z["sample_ids"]])


@dataclass
class DeviceDataset:
    """The packed arrays on the device, uploaded once."""

    strokes: torch.Tensor  # f32 [N, T, 3]
    text: torch.Tensor  # int64 [N, L]
    style: torch.Tensor  # f32 [N, 14, 1280]

    @classmethod
    def from_cache(cls, cache: IAMCache, device: torch.device) -> "DeviceDataset":
        return cls(
            torch.as_tensor(cache.strokes, dtype=torch.float32).to(device),
            torch.as_tensor(np.asarray(cache.text, np.int64)).to(device),
            torch.as_tensor(cache.style, dtype=torch.float32).to(device),
        )

    @property
    def size(self) -> int:
        return self.strokes.shape[0]

    @property
    def arrays(self):
        return self.strokes, self.text, self.style


def gather_batch(arrays, idx: torch.Tensor):
    """(strokes, text, style) rows `idx` ([B] int64 on the arrays' device)."""
    return tuple(a.index_select(0, idx) for a in arrays)


def augment_matrices(u: torch.Tensor, scale: float = 0.0, rotate: float = 0.0,
                     shear: float = 0.0) -> torch.Tensor:
    """Per-sample 2x2 maps A_i = R(theta_i) Shear(h_i) s_i from uniform draws
    u [3, n] in [0, 1): s = 1 + U(-scale, scale), theta = U(-rotate, rotate)
    radians, h = U(-shear, shear). All-zero knobs give identity matrices.

    Strokes are (dx, dy) deltas, so a linear map of the deltas is the same
    map of the trajectory, and padding rows (0, 0, pen 1) stay (0, 0)."""

    def uniform(v, lo, hi):  # jax.random.uniform(minval, maxval)
        return v * (hi - lo) + lo

    s = 1.0 + uniform(u[0], -scale, scale)
    theta = uniform(u[1], -rotate, rotate)
    h = uniform(u[2], -shear, shear)
    cos, sin = torch.cos(theta), torch.sin(theta)
    rows = torch.stack(
        [torch.stack([cos, cos * h - sin], -1), torch.stack([sin, sin * h + cos], -1)], dim=1
    )  # [n, 2, 2]
    return rows * s[:, None, None]


def augment_strokes(mats: torch.Tensor, strokes3: torch.Tensor) -> torch.Tensor:
    """Apply [B, 2, 2] maps to the (dx, dy) channels of [B, T, 3] strokes;
    the pen channel passes through."""
    xy = torch.einsum("btc,bdc->btd", strokes3[..., :2], mats)
    return torch.cat([xy, strokes3[..., 2:]], dim=-1)


def synthetic_cache(n: int = 64, max_seq_len: int = 480, max_text_len: int = 50,
                    seed: int = 0) -> IAMCache:
    """A synthetic IAMCache-shaped dataset (no IAM files, no MobileNet),
    numpy from `seed`, identical to dhg's: smooth random-walk strokes with
    sparse pen lifts, random token texts, random style features."""
    rng = np.random.RandomState(seed)
    deltas = rng.randn(n, max_seq_len, 2).astype(np.float32)
    deltas = (deltas + np.roll(deltas, 1, axis=1)) / 2.0
    deltas /= deltas.std()
    pen = (rng.rand(n, max_seq_len, 1) < 0.05).astype(np.float32)
    strokes = np.concatenate([deltas, pen], axis=-1)

    lengths = rng.randint(10, max_text_len - 1, size=n)
    text = np.zeros((n, max_text_len), dtype=np.int32)
    for i, l in enumerate(lengths):
        text[i, :l] = rng.randint(2, 73, size=l)
        text[i, l] = 1  # EOS

    style = rng.randn(n, 14, 1280).astype(np.float32)
    return IAMCache(strokes=strokes, text=text, style=style,
                    sample_ids=[f"syn-{i:04d}" for i in range(n)])
