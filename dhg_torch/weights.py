"""The weight bridge: dhg params or an exported .pth -> the port's state_dict
(and dhg's StyleExtractor .npz -> the port's, style_state_dict_from_flat).

The port's module names are the reference torch names, the same ones that
`python -m dhg.tools.export_torch_checkpoint` writes, so one strict
`load_state_dict` takes any dhg model. This file keeps the port's own copy
of that mapping (it must not import dhg):

  * Dense kernel [in, out]    -> Linear weight [out, in]
  * Conv kernel [kw, in, out] -> Conv1d weight [out, in, kw]
  * Embedding: same layout
  * FFN {fc1, fc2}            -> Sequential indices .1 / .3 (SiLU at .0/.2)
  * pen_lifts_dense           -> pen_lifts_dense.0
  * att_layers_{i}            -> att_layers.{i}
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _lin(out: dict, key: str, tree: dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(tree["kernel"], np.float32).T)
    out[f"{key}.bias"] = _t(tree["bias"])


def _conv(out: dict, key: str, tree: dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(tree["kernel"], np.float32).transpose(2, 1, 0))
    out[f"{key}.bias"] = _t(tree["bias"])


def _ffn(out: dict, key: str, tree: dict) -> None:
    _lin(out, f"{key}.1", tree["fc1"])
    _lin(out, f"{key}.3", tree["fc2"])


def _affine(out: dict, key: str, tree: dict) -> None:
    _lin(out, f"{key}.gamma_emb", tree["gamma_emb"])
    _lin(out, f"{key}.beta_emb", tree["beta_emb"])


def _mha(out: dict, key: str, tree: dict) -> None:
    for name in ("wq", "wk", "wv", "dense"):
        _lin(out, f"{key}.{name}", tree[name])


def _encoder_layer(out: dict, key: str, tree: dict) -> None:
    _lin(out, f"{key}.text_dense", tree["text_dense"])
    _ffn(out, f"{key}.ffn", tree["ffn"])
    _mha(out, f"{key}.mha", tree["mha"])
    _mha(out, f"{key}.mha2", tree["mha2"])
    for i in range(4):
        _affine(out, f"{key}.affine{i}", tree[f"affine{i}"])


def _conv_block(out: dict, key: str, tree: dict) -> None:
    for name in ("conv_skip", "conv1", "conv2"):
        _conv(out, f"{key}.{name}", tree[name])
    _lin(out, f"{key}.fc", tree["fc"])
    for i in (1, 2, 3):
        _affine(out, f"{key}.affine{i}", tree[f"affine{i}"])


def _text_style(out: dict, key: str, tree: dict) -> None:
    out[f"{key}.emb.weight"] = _t(tree["emb"]["embedding"])
    _ffn(out, f"{key}.style_ffn", tree["style_ffn"])
    _ffn(out, f"{key}.text_ffn", tree["text_ffn"])
    _mha(out, f"{key}.mha", tree["mha"])
    for i in (1, 2, 3, 4):
        _affine(out, f"{key}.affine{i}", tree[f"affine{i}"])


def state_dict_from_dhg(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """dhg params (nested dict of arrays, flax names) -> the port's state_dict.

    float32 CPU tensors; load with `model.load_state_dict(sd, strict=True)`."""
    out: dict = OrderedDict()
    _lin(out, "input_dense", params["input_dense"])
    _ffn(out, "sigma_ffn", params["sigma_ffn"])
    _text_style(out, "text_style_model", params["text_style_model"])
    _lin(out, "att_dense", params["att_dense"])
    _lin(out, "output_dense", params["output_dense"])
    _lin(out, "pen_lifts_dense.0", params["pen_lifts_dense"])
    for i in (1, 2, 3):
        _conv(out, f"skip_conv{i}", params[f"skip_conv{i}"])
    for name in ("enc1", "enc2", "enc4", "dec1", "dec2", "dec3"):
        _conv_block(out, name, params[name])
    for name in ("enc3", "enc5"):
        _encoder_layer(out, name, params[name])
    n_att = sum(1 for k in params if k.startswith("att_layers_"))
    for i in range(n_att):
        _encoder_layer(out, f"att_layers.{i}", params[f"att_layers_{i}"])
    return out


def load_checkpoint(path: str | Path, use_ema: bool = False
                    ) -> tuple[dict, "OrderedDict[str, torch.Tensor]"]:
    """(meta, state_dict) from a `{meta, state_dict}` .pth: the one dhg's
    exporter writes, or a checkpoint of the port's trainer. use_ema picks
    the EMA weights (`ema_state_dict`) where the file carries them."""
    obj = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and "state_dict" in obj):
        raise ValueError(f"{path}: not a {{meta, state_dict}} checkpoint")
    key = "ema_state_dict" if use_ema and obj.get("ema_state_dict") is not None else "state_dict"
    return dict(obj.get("meta") or {}), OrderedDict(obj[key])


def config_from_state_dict(sd: dict) -> dict:
    """The training_args a state_dict was built with (channels, att_layers_num)."""
    channels = int(sd["input_dense.weight"].shape[0])
    n_att = len({k.split(".")[1] for k in sd if k.startswith("att_layers.")})
    return {"channels": channels, "att_layers_num": n_att}


def style_state_dict_from_flat(flat: dict) -> "OrderedDict[str, torch.Tensor]":
    """dhg's flat StyleExtractor .npz ({'params/mobilenet/...': array,
    'batch_stats/mobilenet/...': array}) -> the state_dict of
    dhg_torch.models.style_extractor.StyleExtractor.

      * conv kernel HWIO [kh, kw, in/groups, out] -> Conv2d weight OIHW (the
        depthwise [3, 3, 1, C] -> [C, 1, 3, 3]);
      * BatchNorm scale, bias -> weight, bias; mean, var -> running_mean,
        running_var (num_batches_tracked 0; eval mode never reads it).

    Raises KeyError naming any missing or extra key."""
    from dhg_torch.models.style_extractor import StyleExtractor

    out: dict = OrderedDict()
    used = set()

    def take(key):
        if key not in flat:
            raise KeyError(f"style weights: missing {key}")
        used.add(key)
        return np.asarray(flat[key], np.float32)

    for name in StyleExtractor().state_dict():
        *path, leaf = name.split(".")
        module = "/".join(path)
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.long)
        elif leaf == "weight" and path[-1] in ("conv", "project"):
            out[name] = _t(take(f"params/{module}/kernel").transpose(3, 2, 0, 1))
        else:
            kind, flax_leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                               "running_mean": ("batch_stats", "mean"),
                               "running_var": ("batch_stats", "var")}[leaf]
            out[name] = _t(take(f"{kind}/{module}/{flax_leaf}"))
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"style weights: {len(extra)} unexpected entries, e.g. {extra[:3]}")
    return out


def flat_from_style_state_dict(sd: dict) -> dict[str, np.ndarray]:
    """The inverse of style_state_dict_from_flat: a StyleExtractor state_dict
    -> dhg's flat .npz entries (float32 numpy), which dhg's
    init_style_extractor and the port's load strict.

      * Conv2d weight OIHW -> kernel HWIO;
      * BatchNorm weight, bias -> params/.../scale, bias; running_mean,
        running_var -> batch_stats/.../mean, var (num_batches_tracked is
        dropped: dhg has none)."""
    out: dict[str, np.ndarray] = {}
    for name, value in sd.items():
        *path, leaf = name.split(".")
        module = "/".join(path)
        a = value.detach().cpu().float().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight" and path[-1] in ("conv", "project"):
            out[f"params/{module}/kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        else:
            kind, flax_leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                               "running_mean": ("batch_stats", "mean"),
                               "running_var": ("batch_stats", "var")}[leaf]
            out[f"{kind}/{module}/{flax_leaf}"] = a.copy()
    return out
