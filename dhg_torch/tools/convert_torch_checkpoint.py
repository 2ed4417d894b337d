"""Convert a reference PyTorch checkpoint (.pth) into a checkpoint of the
port (port of dhg/tools/convert_torch_checkpoint.py).

    python -m dhg_torch.tools.convert_torch_checkpoint \
        --src model_final.pth --dst data/converted/model_final

The source is the reference's `{meta, state_dict}` container or a bare
state_dict, with or without DDP's `module.` prefixes. The port's module
names are the reference's, so the weights pass as they are: exactly the
keys that dhg's converter maps (weights.reference_state_dict; a missing key
raises KeyError naming it), as float32. The result is checked with a strict
load into the model its shapes imply, then written with
checkpoint.save_checkpoint, so that DiffusionModel.load and
`python -m dhg_torch.inference --checkpoint_path=<dst> --config=...` read
it. weights.load_checkpoint itself refuses a bare state_dict: this tool is
the route for such files. Host work only, so there is no --device.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="reference .pth checkpoint")
    ap.add_argument("--dst", required=True, help="output checkpoint file")
    args = ap.parse_args(argv)

    import torch

    from dhg_torch.checkpoint import save_checkpoint
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.weights import config_from_state_dict, reference_state_dict

    ckpt = torch.load(args.src, map_location="cpu", weights_only=True)
    state_dict = reference_state_dict(ckpt.get("state_dict", ckpt))
    model = DiffusionModel.from_config(config_from_state_dict(state_dict), device="cpu")
    model.load_state_dict(state_dict, strict=True)

    save_checkpoint(args.dst, state_dict,
                    meta={"converted_by": "dhg_torch.tools.convert_torch_checkpoint",
                          "source_checkpoint": args.src})
    n = sum(int(v.numel()) for v in state_dict.values())
    print(f"wrote {args.dst}: {n} params", flush=True)
    return state_dict


if __name__ == "__main__":
    main()
