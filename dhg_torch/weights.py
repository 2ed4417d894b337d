"""The weight bridge: dhg params or an exported .pth -> the port's state_dict;
a reference state_dict (bare, with DDP's `module.` prefixes) -> the keys dhg
maps, reference_state_dict; dhg's StyleExtractor .npz -> the port's,
style_state_dict_from_flat.

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

import re
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def reference_layers(n_att: int) -> list[tuple[str, tuple[str, ...], str]]:
    """(torch module key, dhg param path, kind) of every layer of the
    reference model with `n_att` att_layers, in the order dhg's exporter
    writes them; kind is "lin" (Linear), "conv" (Conv1d) or "emb"."""
    def ffn(key, path):
        return [(f"{key}.1", (*path, "fc1"), "lin"), (f"{key}.3", (*path, "fc2"), "lin")]

    def affine(key, path, i):
        return [(f"{key}.affine{i}.{n}", (*path, f"affine{i}", n), "lin")
                for n in ("gamma_emb", "beta_emb")]

    def mha(key, path):
        return [(f"{key}.{n}", (*path, n), "lin") for n in ("wq", "wk", "wv", "dense")]

    def encoder_layer(key, path):
        return ([(f"{key}.text_dense", (*path, "text_dense"), "lin")]
                + ffn(f"{key}.ffn", (*path, "ffn"))
                + mha(f"{key}.mha", (*path, "mha")) + mha(f"{key}.mha2", (*path, "mha2"))
                + [x for i in range(4) for x in affine(key, path, i)])

    def conv_block(name):
        return ([(f"{name}.{c}", (name, c), "conv") for c in ("conv_skip", "conv1", "conv2")]
                + [(f"{name}.fc", (name, "fc"), "lin")]
                + [x for i in (1, 2, 3) for x in affine(name, (name,), i)])

    ts, tp = "text_style_model", ("text_style_model",)
    return (
        [("input_dense", ("input_dense",), "lin")] + ffn("sigma_ffn", ("sigma_ffn",))
        + [(f"{ts}.emb", (*tp, "emb"), "emb")] + ffn(f"{ts}.style_ffn", (*tp, "style_ffn"))
        + ffn(f"{ts}.text_ffn", (*tp, "text_ffn")) + mha(f"{ts}.mha", (*tp, "mha"))
        + [x for i in (1, 2, 3, 4) for x in affine(ts, tp, i)]
        + [(name, (name,), "lin") for name in ("att_dense", "output_dense")]
        + [("pen_lifts_dense.0", ("pen_lifts_dense",), "lin")]
        + [(f"skip_conv{i}", (f"skip_conv{i}",), "conv") for i in (1, 2, 3)]
        + [x for name in ("enc1", "enc2", "enc4", "dec1", "dec2", "dec3") for x in conv_block(name)]
        + [x for name in ("enc3", "enc5") for x in encoder_layer(name, (name,))]
        + [x for i in range(n_att) for x in encoder_layer(f"att_layers.{i}", (f"att_layers_{i}",))]
    )


def state_dict_from_dhg(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """dhg params (nested dict of arrays, flax names) -> the port's state_dict.

    float32 CPU tensors; load with `model.load_state_dict(sd, strict=True)`."""
    out: dict = OrderedDict()
    n_att = sum(1 for k in params if k.startswith("att_layers_"))
    for key, path, kind in reference_layers(n_att):
        tree = params
        for name in path:
            tree = tree[name]
        if kind == "emb":
            out[f"{key}.weight"] = _t(tree["embedding"])
            continue
        kernel = np.asarray(tree["kernel"], np.float32)
        out[f"{key}.weight"] = _t(kernel.T if kind == "lin" else kernel.transpose(2, 1, 0))
        out[f"{key}.bias"] = _t(tree["bias"])
    return out


def reference_state_dict(sd: dict) -> "OrderedDict[str, torch.Tensor]":
    """A reference model's state_dict as dhg's convert_state_dict reads it:
    DDP's `module.` prefixes stripped, the att_layers counted from the
    `att_layers.<i>.` keys, exactly the keys that dhg maps (any other is
    dropped) in its exporter's order, as contiguous float32 CPU tensors.
    Raises KeyError naming the first missing key."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    n_att = len({m.group(1) for k in sd if (m := re.match(r"att_layers\.(\d+)\.", k))})
    keys = [f"{key}.{leaf}" for key, _, kind in reference_layers(n_att)
            for leaf in (("weight",) if kind == "emb" else ("weight", "bias"))]
    out: dict = OrderedDict()
    for key in keys:
        if key not in sd:
            raise KeyError(f"reference state_dict: missing {key}")
        out[key] = torch.as_tensor(sd[key]).detach().to("cpu", torch.float32).contiguous()
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
