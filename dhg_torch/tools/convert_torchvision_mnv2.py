"""Offline converter: torchvision MobileNetV2 state_dict -> dhg's .npz
(port of dhg/tools/convert_torchvision_mnv2.py).

    python -m dhg_torch.tools.convert_torchvision_mnv2 \
        --src mobilenet_v2-b0353104.pth --dst data/mobilenetv2_tv.npz

Maps torchvision's `features.*` parameter names onto dhg's flat keys
(`params/mobilenet/{stem, block_<stage>_<i>/{expand, dw, project,
project_bn}, head}/...` and `batch_stats/...`), with:
  * Conv weights [out, in, kh, kw] -> HWIO [kh, kw, in, out];
  * depthwise convs [ch, 1, kh, kw] -> [kh, kw, 1, ch];
  * BatchNorm {weight, bias, running_mean, running_var} -> {scale, bias}
    under 'params' and {mean, var} under 'batch_stats'.

Both packages' init_style_extractor(weights_path=...) load the result
strictly (the port through weights.style_state_dict_from_flat). No
torchvision is needed: the source is a state_dict read with torch.load, or
an .npz of its tensors. Host work only, so there is no --device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dhg_torch.models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS


def _conv_w(w) -> np.ndarray:
    # [out, in/groups, kh, kw] -> HWIO [kh, kw, in/groups, out]
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _bn(out: dict, tv: dict, tv_bn: str, prefix: str) -> None:
    out[f"params/{prefix}/scale"] = np.asarray(tv[f"{tv_bn}.weight"])
    out[f"params/{prefix}/bias"] = np.asarray(tv[f"{tv_bn}.bias"])
    out[f"batch_stats/{prefix}/mean"] = np.asarray(tv[f"{tv_bn}.running_mean"])
    out[f"batch_stats/{prefix}/var"] = np.asarray(tv[f"{tv_bn}.running_var"])


def _emit_convbn(out: dict, tv: dict, tv_prefix: str, prefix: str) -> None:
    """torchvision's Conv2dNormActivation (0 = conv, 1 = bn) -> ConvBNReLU."""
    out[f"params/{prefix}/conv/kernel"] = _conv_w(tv[f"{tv_prefix}.0.weight"])
    _bn(out, tv, f"{tv_prefix}.1", f"{prefix}/bn")


def convert(state_dict: dict) -> dict[str, np.ndarray]:
    """torchvision mobilenet_v2 state_dict (numpy arrays or CPU tensors) ->
    dhg's flat {key: array}; the `classifier.*` entries are left out."""
    tv = {k: v for k, v in state_dict.items() if k.startswith("features.")}
    out: dict[str, np.ndarray] = {}
    _emit_convbn(out, tv, "features.0", "mobilenet/stem")
    feat = 1
    for stage, (t, _, n, _) in enumerate(INVERTED_RESIDUAL_SETTINGS):
        for i in range(n):
            blk, fx = f"features.{feat}.conv", f"mobilenet/block_{stage}_{i}"
            if t == 1:  # conv.0 depthwise ConvBNReLU, conv.1 project, conv.2 its bn
                _emit_convbn(out, tv, f"{blk}.0", f"{fx}/dw")
                proj, proj_bn = f"{blk}.1", f"{blk}.2"
            else:
                _emit_convbn(out, tv, f"{blk}.0", f"{fx}/expand")
                _emit_convbn(out, tv, f"{blk}.1", f"{fx}/dw")
                proj, proj_bn = f"{blk}.2", f"{blk}.3"
            out[f"params/{fx}/project/kernel"] = _conv_w(tv[f"{proj}.weight"])
            _bn(out, tv, proj_bn, f"{fx}/project_bn")
            feat += 1
    _emit_convbn(out, tv, f"features.{feat}", "mobilenet/head")
    return out


def main(argv=None) -> dict[str, np.ndarray]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help=".pth state_dict or .npz of tensors")
    ap.add_argument("--dst", default="data/mobilenetv2_tv.npz")
    args = ap.parse_args(argv)

    src = Path(args.src)
    if src.suffix == ".npz":
        with np.load(src) as f:
            state_dict = dict(f)
    else:
        import torch

        state_dict = {k: v.numpy() for k, v in
                      torch.load(src, map_location="cpu", weights_only=True).items()}
    out = convert(state_dict)
    np.savez_compressed(args.dst, **out)
    print(f"wrote {args.dst} ({len(out)} arrays)", flush=True)
    return out


if __name__ == "__main__":
    main()
