"""The port's three style tools (dhg_torch/tools/eval_style_gap.py,
eval_fsd_sensitivity.py, eval_style_pathway.py) and the four CLIs, train_style_trunk's
too, against dhg on the CPU.

render_line bit for bit; writer_discrimination with data/style_trunk_synth.npz
as both packages' default trunk (2 writers x 3 lines, width 192): top-1
equal, distances within 2e-4; eval_fsd_sensitivity.run with one stub
embedding patched over both packages' feature_fn_for on a tiny packed
cache: corrupt bit for bit, every FSD within 1e-6 relative, the flags
equal; the pathway's conditional validation loss against dhg's
make_eval_fn on dhg's noise draw within 1e-6; the output swap's three
calls share their noise (zero style against itself: MSE 0); each CLI with
--device=cpu on a tiny IAM run (C1 = 32 widths), its report keys dhg's
(read from dhg's source) plus `backend`.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch.tools import eval_fsd_sensitivity as fsd
from dhg_torch.tools import eval_style_gap as gap
from dhg_torch.tools import eval_style_pathway as pathway
from dhg_torch.tools import train_style_trunk as tst

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

ROOT = Path(__file__).resolve().parents[1]
SYNTH = ROOT / "data" / "style_trunk_synth.npz"


def dhg_keys(tool: str, function: str) -> set[str]:
    """Every string key of a dict literal, or of a subscript assignment, in
    `function` of dhg/tools/<tool>.py, but flax's variable collections."""
    tree = ast.parse((ROOT / "dhg" / "tools" / f"{tool}.py").read_text())
    (fn,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function]
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys - {"params", "batch_stats"}


@pytest.mark.parametrize("writer,seed,width", [(0, 0, 384), (3, 397, 192), (7, 7, 96)])
def test_render_line_is_dhgs(writer, seed, width):
    from dhg.tools.eval_style_gap import render_line as dhg_render

    ours, ref = gap.render_line(writer, seed, width), dhg_render(writer, seed, width)
    assert ours.dtype == ref.dtype == np.float32 and np.array_equal(ours, ref)


def test_writer_discrimination_matches_dhg(monkeypatch):
    """Both packages' default trunk patched to data/style_trunk_synth.npz.
    dhg's init_style_extractor returns its module, the file's variables and
    the jitted apply: here built directly, skipping the random init it
    compiles before loading the file (the returned triple is the same)."""
    import flax
    import jax

    import dhg.models.style_extractor as dse
    import dhg_torch.models.style_extractor as pse
    from dhg.tools.eval_style_gap import writer_discrimination as dhg_disc

    def dhg_init(weights_path=None, seed=0, dtype=None, strict=False):
        with np.load(dse.DEFAULT_WEIGHTS_PATH) as f:
            variables = flax.traverse_util.unflatten_dict({tuple(k.split("/")): v
                                                           for k, v in f.items()})
        model = dse.StyleExtractor()
        return model, variables, jax.jit(lambda img: model.apply(variables, img))

    monkeypatch.setattr(dse, "DEFAULT_WEIGHTS_PATH", SYNTH)
    monkeypatch.setattr(dse, "init_style_extractor", dhg_init)
    monkeypatch.setattr(pse, "DEFAULT_WEIGHTS_PATH", SYNTH)
    ref = dhg_disc(n_writers=2, per_writer=3, width=192)
    ours = gap.writer_discrimination(2, 3, 192, device="cpu")
    assert set(ours) == set(ref) | {"backend"} and ours["backend"] == "cpu"
    for key in ("n_writers", "per_writer", "chance"):
        assert ours[key] == ref[key]
    for mine, theirs in ((ours, ref), (ours["pixel_baseline"], ref["pixel_baseline"])):
        assert mine["top1_retrieval"] == theirs["top1_retrieval"]
        for key in ("intra_cos_dist", "inter_cos_dist", "intra_over_inter"):
            assert abs(mine[key] - theirs[key]) <= 2e-4, key


def _stub_embed(pages):
    """One page -> 4-feature embedding for both packages."""
    p = np.asarray(pages, np.float64)
    return np.stack([p.mean((1, 2)), p.std((1, 2)), (p < 128).mean((1, 2)),
                     p[:, :, :64].mean((1, 2))], axis=1)


@pytest.fixture(scope="module")
def packed_cache(tmp_path_factory):
    from dhg_torch.data.pipeline import synthetic_cache

    path = tmp_path_factory.mktemp("cache") / "tiny.npz"
    synthetic_cache(n=12, max_seq_len=96, max_text_len=12, seed=4).save(path)
    return path


def test_fsd_sensitivity_matches_dhg(monkeypatch, packed_cache):
    import dhg.tools.eval_fsd_sensitivity as dhg_fsd

    rows = np.random.RandomState(0).randn(3, 40, 3).astype(np.float32)
    rows[:, -6:] = [0.0, 0.0, 1.0]  # padding
    for c in fsd.LEVELS:
        assert np.array_equal(fsd.corrupt(rows, c, seed=2), dhg_fsd.corrupt(rows, c, seed=2))

    monkeypatch.setattr(dhg_fsd, "feature_fn_for", lambda weights: _stub_embed)
    monkeypatch.setattr(fsd, "feature_fn_for", lambda weights, device: _stub_embed)
    ref = dhg_fsd.run(str(packed_cache), weights=str(SYNTH), n=5, seed=1)
    ours = fsd.run(str(packed_cache), weights=str(SYNTH), n=5, seed=1, device="cpu")
    assert set(ours) == set(ref) | {"backend"}
    for trunk in ("random_init", "trained"):
        o, r = ours[trunk], ref[trunk]
        assert set(o) == set(r)
        for level, value in r["fsd"].items():
            assert abs(o["fsd"][level] - value) <= 1e-6 * abs(value) + 1e-6, (trunk, level)
        assert o["monotone_above_floor"] == r["monotone_above_floor"]
        assert abs(o["noise_floor"] - r["noise_floor"]) <= 1e-6 * r["noise_floor"] + 1e-6
        assert abs(o["feature_std"] - r["feature_std"]) <= 1e-6 * r["feature_std"] + 1e-6


class _Rows:
    """The three arrays of a packed cache that the probe reads."""

    def __init__(self, strokes, text, style):
        self.strokes, self.text, self.style = strokes, text, style

    def __len__(self):
        return len(self.strokes)


def test_val_loss_probe_matches_dhg():
    """Probe 2 on one noise draw (dhg's, from PRNGKey(7), handed to the
    port) for true, zero and shuffled style, against dhg's make_eval_fn as
    eval_style_pathway calls it."""
    import jax

    from dhg.eval import make_eval_fn
    from test_torch_port_common import f32, inputs, jax_model, port_model, random_params, t

    params = random_params(seed=3)
    strokes, text, _, style = inputs(batch=8, seq_len=16, text_len=6, seed=5)
    pen = (np.random.RandomState(6).rand(8, 16) < 0.3).astype(np.float32)
    cache = _Rows(np.concatenate([strokes, pen[..., None]], -1), text, style)
    key = jax.random.PRNGKey(7)
    eval_step = make_eval_fn(jax_model())
    perm = np.random.RandomState(0).permutation(8)
    want = {name: np.asarray(jax.block_until_ready(
                eval_step(params, cache.strokes, text, sty, key)))
            for name, sty in [("true", style), ("zero", np.zeros_like(style)),
                              ("shuffled", style[perm])]}
    eps = t(np.asarray(jax.random.normal(key, strokes.shape)))
    got = pathway.val_losses(port_model(params), cache, eps=eps, device="cpu")
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(f32(torch.from_numpy(got[name])), want[name], rtol=1e-6,
                                   atol=1e-6)


# -- the CLIs on a tiny IAM run ----------------------------------------------------


@pytest.fixture(scope="module")
def iam_run(tmp_path_factory):
    """A generated tree (2 + 4 forms, 3 lines each: 8 or more validation rows kept), a run dir at the C1 = 32
    widths with its config (dataset iam, data/style_trunk_synth.npz) and a
    float32 model_final."""
    from dhg_torch.config import DLConfig
    from dhg_torch.models.denoiser import DiffusionModel
    from dhg_torch.tools import gen_iam_scale

    base = tmp_path_factory.mktemp("iam")
    tree = base / "tree"
    gen_iam_scale.main(root=str(tree), train_forms=2, val_forms=4, lines_per_form=3, seed=7)
    run = base / "run"
    run.mkdir()
    DLConfig({"experiment": {"data_dir": str(tree), "splits_file": str(tree / "splits.json"),
                             "seed": 1},
              "dataset_args": {"style_weights": str(SYNTH), "img_height": 96,
                               "img_width": 1400, "max_seq_len": 480, "max_text_len": 50},
              "training_args": {"channels": 32, "att_layers_num": 2, "dataset": "iam",
                                "cache_dir": str(base / "cache")}}).dump(run / "config.yml")
    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 2}, device="cpu",
                                       seed=3)
    torch.save({"meta": {}, "state_dict": model.state_dict()}, run / "model_final")
    return tree, run


def test_output_swap_shares_noise(iam_run):
    from dhg_torch.models.denoiser import DiffusionModel

    model = DiffusionModel.load(iam_run[1] / "model_final", device="cpu")
    style = torch.from_numpy(np.random.RandomState(1).randn(1, 14, 1280).astype(np.float32))
    zero = torch.zeros_like(style)
    outs = gap.output_swap(model, {"A": style, "zero": zero, "zero again": zero},
                           torch.device("cpu"))
    assert outs["A"].shape == (1, 200, 3) and np.isfinite(outs["A"]).all()
    assert gap._mse(outs["zero"], outs["zero again"]) == 0.0
    assert gap._mse(outs["A"], outs["zero"]) > 0.0


def test_eval_style_gap_cli(iam_run, monkeypatch, capsys):
    monkeypatch.setattr(gap, "BENCHMARK_WRITERS", 2)
    monkeypatch.setattr(gap, "BENCHMARK_LINES", 2)
    monkeypatch.setattr(gap, "BENCHMARK_WIDTH", 128)
    report = gap.main(["--device=cpu", f"--experiment_path={iam_run[1]}"])
    out = capsys.readouterr().out
    assert "== writer discrimination (random-init trunk) ==" in out
    assert "== style-ablation response ==" in out and "  backend: cpu" in out
    disc, abl = report["discrimination"], report["ablation"]
    assert set(disc) == dhg_keys("eval_style_gap", "writer_discrimination") | set(
        dhg_keys("eval_style_gap", "_retrieval_metrics")) | {"backend"}
    assert set(abl) == dhg_keys("eval_style_gap", "style_ablation") | {"backend"}
    assert disc["n_writers"] == 2 and 0.0 <= disc["top1_retrieval"] <= 1.0
    assert abl["mse_A_vs_B"] > 0 and abl["mse_A_vs_zero"] > 0 and np.isfinite(
        abl["output_mean_sq"])


def test_eval_fsd_sensitivity_cli(packed_cache, monkeypatch, capsys):
    """The stub embedding stands in for the trunk (a 1280-wide FSD costs ten
    1280 x 1280 eigendecompositions); the CLI must ask for the random trunk
    and --weights on --device. The trunk's own feature function is checked
    on one page."""
    from dhg_torch.metrics import rasterize_strokes

    page = rasterize_strokes(np.load(packed_cache)["strokes"][0], width=512)[None]
    assert fsd.feature_fn_for(str(SYNTH), "cpu")(page).shape == (1, 1280)
    asked = []
    monkeypatch.setattr(fsd, "feature_fn_for",
                        lambda weights, device: asked.append((weights, device)) or _stub_embed)
    report = fsd.main(["--device=cpu", f"--cache={packed_cache}", f"--weights={SYNTH}", "--n=2"])
    assert asked == [(fsd.RANDOM_TRUNK, torch.device("cpu")), (str(SYNTH), torch.device("cpu"))]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert set(report) == {"n", "levels", "random_init", "trained", "backend"}
    for trunk in ("random_init", "trained"):
        assert set(report[trunk]) == dhg_keys("eval_fsd_sensitivity", "run") - {
            "n", "levels", "random_init", "trained"}
        assert all(np.isfinite(v) for v in report[trunk]["fsd"].values())
        assert report[trunk]["feature_std"] > 0 and report["backend"] == "cpu"


def test_eval_style_pathway_cli(iam_run, capsys):
    tree, run = iam_run
    report = pathway.main(["--device=cpu", f"--experiment_path={run}"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    keys = dhg_keys("eval_style_pathway", "run")
    assert set(report) == {"checkpoint", "output_swap", "val_loss_by_style"} | {"backend"}
    assert set(report["output_swap"]) == keys - {"checkpoint", "output_swap",
                                                  "val_loss_by_style", "style_informative"}
    # dhg's loss dict: one entry a style variant (named in a loop) and its flag
    assert set(report["val_loss_by_style"]) == {"true", "zero", "shuffled", "style_informative"}
    assert "style_informative" in keys
    assert report["output_swap"]["mse_A_vs_B"] > 0
    assert all(len(report["val_loss_by_style"][k]) == 3 for k in ("true", "zero", "shuffled"))


def test_train_style_trunk_cli(iam_run, tmp_path, capsys):
    """Tree mode (writer = form, the holdout from the same tree), 51 steps
    (the schedule needs more than its 50 warm-up steps) at batch 2, width 96."""
    out = tmp_path / "trunk.npz"
    report = tst.main(["--device=cpu", f"--tree={iam_run[0]}", "--steps=51", "--batch=2",
                       "--width=96", "--writers=3", "--log_every=50", f"--out={out}"])
    text = capsys.readouterr().out
    assert "step 1/51 | ce " in text and "step 50/51 | ce " in text
    res = report["train"]
    assert set(res) == dhg_keys("train_style_trunk", "train") | {"backend"}
    assert res["out"] == str(out) and np.isfinite(res["final_ce"])
    assert set(res["holdout_retrieval"]) == dhg_keys("eval_style_gap", "_retrieval_metrics")
    from dhg_torch.models.style_extractor import init_style_extractor

    init_style_extractor(out, strict=True, device="cpu")  # a style_weights file
