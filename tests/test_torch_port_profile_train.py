"""dhg's profile_train in the port (dhg_torch/tools/profile_train.py): the
report's keys against the `result = {...}` literal of dhg's tool (read from
its source: dhg's `profile` compiles a 96-row chunk and is not run here),
the signature and CLI flags against dhg's, one `profile(device="cpu")` run
at a tiny size, and the forward-only body against the train step's forward.

Tiny size: channels 16, 1 attention layer, T 32, 14 text tokens, batch 4,
one 16-step window (profile_config monkeypatched; the CLI has no knob).
"""

import ast
import inspect
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dhg_torch.config import DLConfig, fit_config
from dhg_torch.tools import profile_train
from dhg_torch.train import Trainer

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

ROOT = Path(__file__).resolve().parents[1]
DHG_TOOL = ROOT / "dhg" / "tools" / "profile_train.py"
# The one renamed key (dhg's names the v5e's peak) and the one added.
RENAMED = {"mfu_vs_v5e_bf16_peak": "mfu_vs_h100_bf16_peak"}
ADDED = {"device"}
TINY = {"training_args.channels": 16, "training_args.att_layers_num": 1,
        "dataset_args.max_seq_len": 32, "dataset_args.max_text_len": 14}


def tiny_config(batch: int, **extra) -> dict:
    return fit_config(config="smoke.yml", **{"training_args.batch_size": batch,
                                             "training_args.max_files": 32, **TINY, **extra})


def dhg_function(name: str) -> ast.FunctionDef:
    tree = ast.parse(DHG_TOOL.read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name]
    return fn


def dhg_result_keys() -> list[str]:
    """The keys of dhg's `result = {...}` literal, in order."""
    (node,) = [n for n in ast.walk(dhg_function("profile")) if isinstance(n, ast.Assign)
               and [ast.unparse(t) for t in n.targets] == ["result"]]
    return [k.value for k in node.value.keys]


def dhg_cli_defaults() -> dict:
    """main's kv.get(name, default) pairs (a missing default is None)."""
    out = {}
    for node in ast.walk(dhg_function("main")):
        if isinstance(node, ast.Call) and ast.unparse(node.func) == "kv.get":
            args = [ast.literal_eval(a) for a in node.args]
            out[args[0]] = args[1] if len(args) > 1 else None
    return out


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """One profile(device="cpu") at the tiny size, with a trace, and its stdout."""
    import contextlib
    import io

    trace = tmp_path_factory.mktemp("trace")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profile_train, "profile_config", tiny_config)
        with contextlib.redirect_stdout(buf):
            r = profile_train.profile(batch=4, steps_per_window=16, trace_dir=str(trace),
                                      device="cpu")
    return r, buf.getvalue(), trace


def test_keys_are_dhgs_with_one_rename(report):
    r, printed, _ = report
    want = [RENAMED.get(k, k) for k in dhg_result_keys()]
    assert set(r) == set(want) | ADDED
    assert [k for k in r if k not in ADDED] == want  # dhg's order
    assert printed.count("\n") == 1 and json.loads(printed) == r  # one JSON line


def test_signature_and_cli_flags_are_dhgs(monkeypatch):
    fn = dhg_function("profile")
    names = [a.arg for a in fn.args.args]
    defaults = [ast.literal_eval(d) for d in fn.args.defaults]
    sig = inspect.signature(profile_train.profile).parameters
    assert list(sig) == names + ["device"]
    assert [sig[n].default for n in names] == defaults == [96, 96, None]
    assert sig["device"].default == "cuda"
    cli = dhg_cli_defaults()
    assert cli == {"batch": 96, "steps_per_window": 96, "trace_dir": None}
    seen = []
    monkeypatch.setattr(profile_train, "profile", lambda **kw: seen.append(kw) or kw)
    profile_train.main([])
    profile_train.main(["--batch=8", "--steps_per_window=32", "--trace_dir=/x"])
    profile_train.main(["--trace-dir=/y", "--device=cpu"])
    assert seen == [dict(cli, device="cuda"),
                    dict(batch=8, steps_per_window=32, trace_dir="/x", device="cuda"),
                    dict(cli, trace_dir="/y", device="cpu")]
    with pytest.raises(SystemExit):  # the kernel table's flags need its mode
        profile_train.main(["--distill"])


def test_profile_on_the_cpu(report):
    r, _, trace = report
    assert (r["batch"], r["backend"], r["device"], r["trace_dir"]) == (4, "cpu", "cpu",
                                                                         str(trace))
    assert len(r["rate_trials"]) == 3 and r["steps_per_sec"] > 0
    # dhg's rounding: the rate to 0.01, the milliseconds to 0.001.
    assert abs(r["ms_per_step"] - 1000 / r["steps_per_sec"]) <= (
        1000 / r["steps_per_sec"] ** 2 * 0.005 + 0.0005)
    assert abs(r["fwd_only_ms"] - 1000 / r["fwd_only_steps_per_sec"]) <= (
        1000 / r["fwd_only_steps_per_sec"] ** 2 * 0.005 + 0.0005)
    assert abs(r["bwd_plus_update_ms"] - (r["ms_per_step"] - r["fwd_only_ms"])) <= 0.0011
    assert r["hbm_bytes_per_step"] is r["hbm_bw_gbps"] is r["hbm_bw_util"] is None
    assert abs(r["samples_per_sec"] - r["steps_per_sec"] * 4) <= 1
    # An independent count: one train_step of a fresh trainer, the same seed.
    t = Trainer(DLConfig(tiny_config(4)), device="cpu")
    with FlopCounterMode(display=False) as counter:
        t.train_step(t.draw(1))
    assert r["flops_per_step"] == counter.get_total_flops() > 0
    peak = profile_train.H100_BF16_PEAK_FLOPS
    mfu = r["flops_per_step"] * r["steps_per_sec"] / peak
    assert abs(r["mfu_vs_h100_bf16_peak"] - mfu) <= 5e-5 + mfu * 1e-3
    (path,) = trace.iterdir()
    assert path.name == "train_chunks_50000-50015.json"
    assert "traceEvents" in json.loads(path.read_text())


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_forward_body_is_the_steps_forward(grad_accum):
    """forward_step's [3] losses on draw(c) equal train_step(draw(c))'s row
    from the same params, bit for bit, with live dropout; the forward
    changes no param and leaves no gradient."""
    cfg = DLConfig(tiny_config(4, **{"training_args.dropout": 0.1,
                                     "training_args.grad_accum": grad_accum}))
    t = Trainer(cfg, device="cpu")
    before = [p.detach().clone() for p in t.opt.params]
    fwd = t.forward_step(t.draw(5))
    assert all(torch.equal(a, p) and p.grad is None for a, p in zip(before, t.opt.params))
    assert torch.equal(t.forward_chunk(5, 1)[0], fwd)
    d = t.draw(5)
    # The dropout is live: the same draws under another seed give other losses.
    assert not torch.equal(t.forward_step(d._replace(dropout_seed=d.dropout_seed + 1)), fwd)
    row = t.train_step(t.draw(5))
    assert torch.equal(fwd, row)
    assert not all(torch.equal(a, p) for a, p in zip(before, t.opt.params))
