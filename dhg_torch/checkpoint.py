"""Checkpoint files of the port's trainer (its own torch.save format, with
dhg/checkpoint.py's discovery and retention semantics).

Every checkpoint is one file holding `{meta, state_dict}` — the layout
DiffusionModel.load reads — plus what the trainer needs:
  * `checkpoint_<N>`: state_dict, optimizer state, step N, ema_state_dict;
  * `model_final`: state_dict and ema_state_dict;
  * `checkpoint_last` + `model_last` on an interrupt.
Discovery for sampling: model_final, then model_last, then the highest
checkpoint_<N>. Saves run on a background thread from a CPU snapshot taken
when they are submitted (the trainer updates its tensors in place).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


def snapshot(tree):
    """A CPU copy of a nested dict of tensors; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: Path | str, state_dict, optimizer=None, step: int | None = None,
                    meta: dict | None = None, ema_state_dict=None) -> None:
    """Write one checkpoint file at `path` (atomically: temp name, rename)."""
    payload = {"meta": {k: str(v) for k, v in (meta or {}).items()},
               "state_dict": snapshot(state_dict)}
    if ema_state_dict is not None:
        payload["ema_state_dict"] = snapshot(ema_state_dict)
    if optimizer is not None:
        payload["optimizer"] = snapshot(optimizer)
    if step is not None:
        payload["step"] = int(step)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: Path | str) -> dict:
    """The whole payload of a checkpoint file, on the CPU."""
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def _numbered(exp_dir: Path | str) -> list[tuple[int, Path]]:
    out = []
    for p in Path(exp_dir).glob("checkpoint_*"):
        suffix = p.name.split("_", 1)[1]
        if suffix.isdigit():
            out.append((int(suffix), p))
    return sorted(out)


def resolve_checkpoint(experiment_path: Path | str) -> Path | None:
    """The newest checkpoint of a run dir, in the reference's order."""
    exp = Path(experiment_path)
    for name in ("model_final", "model_last"):
        if (exp / name).exists():
            return exp / name
    numbered = _numbered(exp)
    return numbered[-1][1] if numbered else None


def resolve_run_paths(experiment_path=None, config_path=None, checkpoint_path=None
                      ) -> tuple[str, str]:
    """(config, checkpoint) of a run: experiment_path supplies config.yml
    and resolve_checkpoint's pick; explicit paths win. Raises if either is
    still missing."""
    if experiment_path:
        exp = Path(experiment_path)
        if not config_path:
            config_path = str(exp / "config.yml")
        if not checkpoint_path:
            found = resolve_checkpoint(exp)
            if found is not None:
                checkpoint_path = str(found)
    if not config_path or not checkpoint_path:
        raise ValueError(
            "Both config_path and checkpoint_path must be provided, "
            "either directly or via experiment_path."
        )
    return str(config_path), str(checkpoint_path)


def prune_numbered_checkpoints(exp_dir: Path | str, keep: int) -> list[Path]:
    """Delete all but the `keep` highest checkpoint_<N>; named saves
    (model_final, model_last, checkpoint_last) are never candidates."""
    if keep < 1:
        raise ValueError(f"keep_checkpoints must be >= 1, got {keep}")
    doomed = [p for _, p in _numbered(exp_dir)[:-keep]]
    for p in doomed:
        logger.info("Pruning old checkpoint %s (keep_checkpoints=%d)", p, keep)
        p.unlink(missing_ok=True)
    return doomed


class AsyncSaver:
    """One background thread that writes checkpoints; `wait()` drains it."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err: Exception | None = None
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            path, kwargs, keep = self._q.get()
            try:
                save_checkpoint(path, **kwargs)
                if keep:
                    # Prune only after this save landed: never fewer than
                    # `keep` complete numbered checkpoints on disk.
                    prune_numbered_checkpoints(Path(path).parent, keep)
            except Exception as e:  # surfaced by wait()
                logger.warning("async checkpoint save failed for %s: %s", path, e)
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, path, state_dict, optimizer=None, ema_state_dict=None, keep=None, **kwargs):
        """Snapshot to the CPU now, write later."""
        kwargs.update(state_dict=snapshot(state_dict), optimizer=snapshot(optimizer),
                      ema_state_dict=snapshot(ema_state_dict))
        self._q.put((path, kwargs, keep))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err
