"""Export a run of the port as a reference-compatible PyTorch checkpoint
(.pth), the EMA weights preferred (port of
dhg/tools/export_torch_checkpoint.py).

    python -m dhg_torch.tools.export_torch_checkpoint \
        --experiment_path <run dir> --dst model_final.pth [--use_ema=false]
    # or one checkpoint file of the port's trainer:
    python -m dhg_torch.tools.export_torch_checkpoint --src <run dir>/checkpoint_500 --dst out.pth

The port's module names are the reference's, so the state_dict passes as it
is: `ema_state_dict` where the checkpoint has one and --use_ema holds (the
default), else `state_dict`, in dhg's exporter's key order as contiguous
float32 tensors. It is wrapped in the reference's container `{"meta": ...,
"state_dict": ...}`, which the reference's loader reads (it reads only
`state_dict`, so a checkpoint of the port handed over as it is would lose
its EMA). The file holds no optimizer state and no second set of weights.
A run dir is resolved as the reference does: model_final, then model_last,
then the highest checkpoint_<N>. Host work only, so there is no --device.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--src", help="checkpoint file of the port's trainer")
    src.add_argument(
        "--experiment_path",
        help="run dir; newest checkpoint discovered in reference order "
        "(model_final -> model_last -> highest checkpoint_<N>)",
    )
    ap.add_argument("--dst", required=True, help="output .pth path")
    ap.add_argument(
        "--use_ema",
        default=True,
        type=lambda s: s.lower() not in ("0", "false", "no"),
        help="prefer the EMA shadow when the checkpoint carries one (default true)",
    )
    args = ap.parse_args(argv)

    import torch

    from dhg_torch.checkpoint import load_checkpoint, resolve_checkpoint
    from dhg_torch.weights import reference_state_dict

    if args.src:
        ckpt_path = Path(args.src)
    else:
        ckpt_path = resolve_checkpoint(args.experiment_path)
        if ckpt_path is None:
            raise SystemExit(f"no checkpoint found under {args.experiment_path}")

    restored = load_checkpoint(ckpt_path)
    used_ema = bool(args.use_ema) and restored.get("ema_state_dict") is not None
    state_dict = reference_state_dict(
        restored["ema_state_dict" if used_ema else "state_dict"])
    meta = {
        "exported_by": "dhg_torch.tools.export_torch_checkpoint",
        "source_checkpoint": str(ckpt_path),
        "ema": used_ema,
    }
    if "step" in restored:
        meta["step"] = int(restored["step"])
    payload = {"meta": meta, "state_dict": state_dict}
    torch.save(payload, args.dst)
    n = sum(int(v.numel()) for v in state_dict.values())
    print(f"wrote {args.dst}: {len(state_dict)} tensors, {n} params (ema={used_ema})",
          flush=True)
    return payload


if __name__ == "__main__":
    main()
