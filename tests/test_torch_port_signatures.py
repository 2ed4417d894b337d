"""Every public function and class that dhg and the port both define, in
every module the two packages have under the same path, takes dhg's
parameters: the same names, in the same order, with the same defaults.

The differences that are meant are listed below, each with its reason:
RULES by parameter name, wherever it occurs, and GAPS by function. A
listed difference that no longer occurs fails too, so the lists stay true.
DHG_ONLY names dhg's modules that have no module of the same path in the
port, and why.
"""

import importlib
import inspect
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DHG, PORT = ROOT / "dhg", ROOT / "dhg_torch"

DHG_ONLY = {
    "ops/init.py": "flax initializers drawing torch's default init; in the port "
                   "models/denoiser.py::init_weights",
    "tools/bench_reference_cpu.py": "times the original PyTorch code from a checkout that is "
                                    "not in the repository, on the host CPU: it measures "
                                    "neither package",
    "utils/env.py": "collect_env and git_sha, in dhg_torch/utils/experiment.py",
    "utils/log.py": "get_logger, in dhg_torch/utils/experiment.py",
    "utils/path.py": "one-line path helpers the port inlines (pathlib)",
}

# (side, parameter name) -> why that side alone may have it.
RULES = {
    ("port", "device"): "the port runs on the card unless the caller asks for the CPU",
    ("port", "argv"): "the port's CLI mains take their argv, so the tests call them in-process",
    ("dhg", "parent"): "flax.linen.Module's own field",
    ("dhg", "name"): "flax.linen.Module's own field",
    ("dhg", "params"): "flax keeps the weights beside the module; a torch module holds them",
    ("dhg", "interpret"): "Pallas's interpret mode; a CUDA wrapper takes its plain version for "
                          "CPU tensors",
    ("dhg", "rows"): "a Pallas grid's rows a step, a TPU lowering choice with the same output",
    ("dhg", "batched"): "dhg's batched-SDPA lowering, a TPU choice with the same output",
    ("port", "tiles"): "the tiled weight copy a Hopper kernel streams, cached by DiffusionModel",
    ("dhg", "key"): "JAX keys against torch generators",
    ("dhg", "sample_keys"): "JAX keys against torch generators",
    ("port", "generator"): "JAX keys against torch generators",
    ("port", "x_init"): "torch takes the draws themselves, so dhg's can be fed in",
    ("port", "noises"): "torch takes the draws themselves, so dhg's can be fed in",
    ("port", "sample_seeds"): "one seed a line in place of dhg's key a line",
    ("dhg", "dtype"): "JAX code is handed its compute dtype; the port's follows its model's "
                      "or inputs' (the style trunk and the samplers' draws are float32)",
    ("port", "d_in"): "a torch module is given its input width; flax infers it at the first call",
    ("port", "cin"): "a torch module is given its input width; flax infers it at the first call",
    ("port", "sigma_dim"): "a torch module is given its input width; flax infers it at the "
                           "first call",
    ("port", "stats"): "a dict the port's build fills with its stage timings",
}


class Gap(NamedTuple):
    """One function's differences: the parameters dropped from dhg's side
    and from the port's before the rest compare (a rename, a default that
    differs or a parameter one side alone has), and why. any_order: the
    rest may differ in order only."""

    dhg: tuple
    port: tuple
    reason: str
    any_order: bool = False


CONV_OPS = ("wskip", "bskip", "w1", "b1", "w2", "b2", "wfc", "bfc", "g1", "be1", "g2", "be2",
            "g3", "be3")
STEP_CTX = ("dhg scans each step's conditioning (step_ctx) through its jitted loop; the port's "
            "Python loop hands denoise_fn the step, whose closure holds the conditioning")
LAST_BY_KEYWORD = ("encoder_reuse and mesh (and generate's hoist) come last in the port, after "
                   "the arguments it had first; every caller passes them by keyword")
NEG = "the same [B, 1, L] additive mask under a shorter name"

GAPS = {
    "checkpoint.py::save_checkpoint": Gap(
        ("opt_state", "ema_params"), ("state_dict", "optimizer", "ema_state_dict"),
        "the file's fields under torch's names: a state_dict, the optimizer's state, the EMA "
        "state_dict, where dhg saves flax trees (params, optax's opt_state, ema_params)"),
    "config.py::config_entrypoint": Gap(
        (), ("kwargs",), "a CLI takes --device off the parsed flags, then passes the rest"),
    "core/sampling.py::diffusion_sample": Gap(("step_ctx",), (), STEP_CTX),
    "core/sampling.py::diffusion_sample_encoder_reuse": Gap(("step_ctx",), (), STEP_CTX),
    "core/sampling.py::per_sample_noise_streams": Gap(
        (), ("seeds",), "one seed a line in place of dhg's key a line (sample_keys)"),
    "data/pipeline.py::augment_matrices": Gap(
        ("n",), ("u",), "the [3, B] uniform draws themselves, which dhg draws from its key for "
                        "n rows"),
    "data/pipeline.py::augment_strokes": Gap(
        ("knobs",), ("mats",), "augment_matrices' matrices, which dhg makes from its key and "
                               "knobs"),
    "data/pipeline.py::gather_batch": Gap(
        ("batch_size",), ("idx",), "the drawn rows themselves, which dhg draws from its key"),
    "distill.py::Distiller": Gap(
        ("teacher_params",), ("teacher_state",), "the teacher's weights as a torch state_dict"),
    "distill.py::probe_fidelity": Gap(
        ("model", "teacher_params", "student_params"), ("teacher", "student"),
        "two torch models, where dhg passes one flax module and two param trees"),
    "eval.py::evaluate": Gap(
        (), ("n_levels",), "the port takes evaluate_checkpoint's n_levels, for the step it builds "
                           "when it is given none"),
    "inference.py::generate": Gap((), (), LAST_BY_KEYWORD, any_order=True),
    "inference.py::sample_lines": Gap((), (), LAST_BY_KEYWORD, any_order=True),
    "kernels/fused_bottleneck.py::fused_bottleneck": Gap(("neg_mask",), ("neg",), NEG),
    "kernels/fused_bottleneck.py::fused_encoder_layer": Gap(("neg_mask",), ("neg",), NEG),
    "kernels/fused_bottleneck.py::fused_unet_t4": Gap(("neg_mask",), ("neg",), NEG),
    "kernels/fused_conv_block.py::fused_conv_block": Gap(
        CONV_OPS, ("ops",), "the 14 operands as *ops, in dhg's order (fused_conv_block.NAMES)"),
    "models/encoder_layer.py::EncoderLayer": Gap(
        ("drop_rate", "d_inp"), ("drop_rate", "d_inp"),
        "the torch layer is given its input width d_inp (third, no default) and its dropout "
        "(last, default off); its caller, DiffusionModel, passes both"),
    "models/mobilenetv2.py::ConvBNReLU": Gap(("features",), ("cout",), "torch's name"),
    "models/mobilenetv2.py::InvertedResidual": Gap(("out_ch",), ("cout",), "torch's name"),
    "models/text_style.py::TextStyleEncoder": Gap(
        ("d_ff",), ("d_ff",), "no default: its caller, DiffusionModel, passes c2 * 4"),
    "ops/basic.py::FFN": Gap(
        ("hidden", "act_before"), ("hidden",),
        "widths in torch's order (d_in, hidden, out), hidden without dhg's 768 default; the "
        "port's FFN is dhg's act_before=True form, the only one dhg's model uses",
        any_order=True),
    "ops/conv.py::ConvBlock": Gap(
        ("dilation",), (), "dilation is 1 in every ConvBlock of dhg's model; dtype comes before "
                           "drop_rate", any_order=True),
    "parallel/mesh.py::make_mesh": Gap(
        ("devices",), (), "JAX's device list; the port's mesh is over the process group's ranks"),
    "train.py::make_optimizer": Gap(
        (), ("model", "model_group"), "a torch optimizer is built over the model's parameters; "
                                      "model_group clips a sharded model's gradients"),
    "utils/experiment.py::ExperimentDir": Gap(
        ("logger_name",), ("logger_name",), "the port's logger is named under its package"),
    "utils/experiment.py::set_random_seed": Gap(
        ("seed", "deterministic"), ("seed",),
        "seed without dhg's 42 default (its caller, ExperimentDir, passes the config's); dhg's "
        "deterministic does nothing (XLA programs are deterministic per compile)"),
}


def module_name(rel: str) -> str:
    parts = rel[:-3].split("/")
    return ".".join(p for p in parts if p != "__init__")


def shared_modules() -> list[str]:
    dhg = {str(p.relative_to(DHG)) for p in DHG.rglob("*.py")}
    port = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    return sorted(dhg & port)


def public(mod) -> dict:
    """name -> inspect.Signature of each public function or class defined
    in `mod` (a jitted function through its __wrapped__; a class by its
    constructor)."""
    out = {}
    for k, v in vars(mod).items():
        if k.startswith("_") or not callable(v):
            continue
        fn = inspect.unwrap(v) if not inspect.isclass(v) else v
        if getattr(fn, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(fn) or inspect.isclass(fn):
            try:
                out[k] = inspect.signature(fn)
            except ValueError:  # a class without a Python constructor (a dict)
                pass
    return out


def norm(default):
    """A default, with dtypes by name (jnp.float32 and torch.float32 agree)."""
    if default is inspect.Parameter.empty:
        return "<required>"
    if isinstance(default, torch.dtype):
        return str(default).rsplit(".", 1)[-1]
    if isinstance(default, type) and hasattr(default, "dtype"):
        return np.dtype(default).name
    return default


def params(sig: inspect.Signature, side: str, drop, other: set) -> list:
    """(name, default) of each parameter of `sig` that is not dropped: by
    GAPS (`drop`), or by RULES where the `other` side has no such name."""
    out = []
    for p in sig.parameters.values():
        if p.name in drop or ((side, p.name) in RULES and p.name not in other):
            continue
        stars = {p.VAR_POSITIONAL: "*", p.VAR_KEYWORD: "**"}.get(p.kind, "")
        out.append((stars + p.name, norm(p.default)))
    return out


def differences(rel: str) -> list[str]:
    name = module_name(rel)
    dhg = public(importlib.import_module(f"dhg.{name}" if name else "dhg"))
    port = public(importlib.import_module(f"dhg_torch.{name}" if name else "dhg_torch"))
    out = []
    for fn in sorted(dhg.keys() & port.keys()):
        key = f"{rel}::{fn}"
        gap = GAPS.get(key, Gap((), (), ""))
        drop_dhg, drop_port = gap.dhg, gap.port
        names = {"dhg": set(dhg[fn].parameters), "port": set(port[fn].parameters)}
        stale = [f"{side} {p}" for side, drop in (("dhg", drop_dhg), ("port", drop_port))
                 for p in drop if p not in names[side]]
        a = params(dhg[fn], "dhg", drop_dhg, names["port"])
        b = params(port[fn], "port", drop_port, names["dhg"])
        same = sorted(a, key=repr) == sorted(b, key=repr) if gap.any_order else a == b
        if stale:
            out.append(f"{key}: GAPS lists {stale}, which it no longer has")
        if not same:
            out.append(f"{key}:\n  dhg  {a}\n  port {b}")
    return out


def test_the_modules_dhg_alone_has():
    dhg = {str(p.relative_to(DHG)) for p in DHG.rglob("*.py")}
    assert dhg - set(shared_modules()) == set(DHG_ONLY)


def test_every_listed_gap_names_a_shared_function():
    for key, gap in GAPS.items():
        rel, fn = key.split("::")
        assert rel in shared_modules() and gap.reason, key


def test_every_rule_is_used():
    """Each RULES entry drops a parameter somewhere (else it is stale)."""
    used = set()
    for rel in shared_modules():
        name = module_name(rel)
        dhg = public(importlib.import_module(f"dhg.{name}" if name else "dhg"))
        port = public(importlib.import_module(f"dhg_torch.{name}" if name else "dhg_torch"))
        for fn in dhg.keys() & port.keys():
            names = {"dhg": set(dhg[fn].parameters), "port": set(port[fn].parameters)}
            for side, other in (("dhg", "port"), ("port", "dhg")):
                used |= {(side, p) for p in names[side] - names[other]}
    assert set(RULES) <= used, set(RULES) - used


def test_conv_block_operands_in_dhgs_order():
    from dhg_torch.kernels.fused_conv_block import NAMES

    dhg = importlib.import_module("dhg.kernels.fused_conv_block").fused_conv_block
    assert list(inspect.signature(inspect.unwrap(dhg)).parameters)[1:len(CONV_OPS) + 1] == list(
        CONV_OPS) == list(NAMES)


@pytest.mark.parametrize("rel", shared_modules())
def test_signatures_are_dhgs(rel):
    assert differences(rel) == []
