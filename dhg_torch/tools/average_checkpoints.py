"""Average N checkpoints into one (port of dhg/tools/average_checkpoints.py).

A uniform (or weighted) mean of the parameters over the tail of a run, a
cheap ensemble beside the EMA shadow, on the port's checkpoint files
(dhg_torch/checkpoint.py).

    python -m dhg_torch.tools.average_checkpoints \
        --dst <out file> --srcs <ckpt>,<ckpt>[,...] [--weights 1,2,...]
    # or every numbered checkpoint of a run:
    python -m dhg_torch.tools.average_checkpoints --dst <out file> \
        --experiment_path <run dir> [--last 3]

The output is a `{meta, state_dict}` checkpoint that DiffusionModel.load,
infer, eval, metrics and serve read like any other. When every source has
an EMA shadow, the shadows are averaged too (ema_state_dict, preferred when
sampling); if any lacks one, the output has none.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def average_trees(trees: list, weights: list[float] | None = None):
    """Weighted elementwise mean of nested dicts (or lists, tuples) of the
    same structure, with torch tensors or numpy arrays as leaves: summed in
    float64, returned in each leaf's own type and dtype."""
    if not trees:
        raise ValueError("no trees to average")
    if weights is None:
        weights = [1.0] * len(trees)
    if len(weights) != len(trees):
        raise ValueError(f"{len(weights)} weights for {len(trees)} trees")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("weights must sum to a positive value")
    norm = [float(w) / total for w in weights]

    def avg(*leaves):
        first = leaves[0]
        if isinstance(first, dict):
            if any(set(leaf) != set(first) for leaf in leaves):
                raise ValueError("trees differ in their keys")
            return {k: avg(*(leaf[k] for leaf in leaves)) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(avg(*parts) for parts in zip(*leaves))
        if isinstance(first, torch.Tensor):
            out = torch.zeros(first.shape, dtype=torch.float64)
            for w, leaf in zip(norm, leaves):
                out += w * leaf.detach().to("cpu", torch.float64)
            return out.to(first.dtype)
        out = np.zeros_like(np.asarray(first, np.float64))
        for w, leaf in zip(norm, leaves):
            out += w * np.asarray(leaf, np.float64)
        return out.astype(np.asarray(first).dtype)

    return avg(*trees)


def average_checkpoints(srcs: list[str | Path], dst: str | Path,
                        weights: list[float] | None = None) -> dict:
    """Average the state_dicts (and, when all have one, the EMA shadows) of
    `srcs` into a new checkpoint at `dst`. Returns what was saved."""
    from dhg_torch.checkpoint import load_checkpoint, save_checkpoint

    if len(srcs) < 2:
        raise ValueError("need at least two checkpoints to average")
    restored = [load_checkpoint(s) for s in srcs]
    payload = {"state_dict": average_trees([r["state_dict"] for r in restored], weights)}
    if all(r.get("ema_state_dict") is not None for r in restored):
        payload["ema_state_dict"] = average_trees([r["ema_state_dict"] for r in restored],
                                                  weights)
    save_checkpoint(Path(dst), payload["state_dict"],
                    ema_state_dict=payload.get("ema_state_dict"),
                    meta={"averaged_from": ",".join(str(s) for s in srcs)})
    return payload


def numbered_checkpoints(experiment_path: str | Path, last: int = 0) -> list[Path]:
    """checkpoint_<N> files of a run in step order; `last` keeps the tail."""
    exp = Path(experiment_path)
    numbered = []
    for p in exp.glob("checkpoint_*"):
        try:
            numbered.append((int(p.name.split("_")[1]), p))
        except ValueError:
            continue
    paths = [p for _, p in sorted(numbered)]
    return paths[-last:] if last else paths


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dst", required=True, help="output checkpoint file")
    ap.add_argument("--srcs", help="comma-separated checkpoint files")
    ap.add_argument("--experiment_path", help="run dir: average its checkpoint_<N>s")
    ap.add_argument("--last", type=int, default=0, help="with --experiment_path: only the last N")
    ap.add_argument("--weights", help="comma-separated weights (default uniform)")
    args = ap.parse_args(argv)

    if bool(args.srcs) == bool(args.experiment_path):
        raise SystemExit("provide exactly one of --srcs or --experiment_path")
    if args.srcs:
        srcs = [s for s in args.srcs.split(",") if s.strip()]
    else:
        srcs = numbered_checkpoints(args.experiment_path, last=args.last)
        if len(srcs) < 2:
            raise SystemExit(
                f"found {len(srcs)} numbered checkpoints under "
                f"{args.experiment_path}; need at least 2"
            )
    weights = None
    if args.weights:
        weights = [float(w) for w in args.weights.split(",") if w.strip()]

    payload = average_checkpoints(srcs, args.dst, weights)
    n = sum(t.numel() for t in payload["state_dict"].values())
    print(f"wrote {args.dst}: mean of {len(srcs)} checkpoints, {n} params"
          + (" (+ema)" if "ema_state_dict" in payload else ""), flush=True)
    return payload


if __name__ == "__main__":
    main()
