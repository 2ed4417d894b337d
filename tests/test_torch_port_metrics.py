"""The port's generation metrics, checkpoint averaging and eval CLI against
dhg's, on the CPU.

rasterize_strokes exactly dhg's; stroke_stats, ks_distance and
compare_stroke_sets to 1e-12; frechet_distance to 1e-6 relative;
frechet_style_distance on one stub embedding equal to dhg's; average_trees
against dhg's on the same numpy trees to 1e-7, and on torch state dicts;
average_checkpoints on the port's files (EMA averaged only when every source
has one) and its CLI; `evaluate` against a direct sample-weighted mean of
`eval_batch` on the same draws; the eval and metrics CLIs on a tiny run
(synthetic data), the metrics sampler defaults of a distilled student.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import dhg.metrics as jax_metrics
from dhg.tools import average_checkpoints as jax_avg
from dhg_torch import checkpoint as ck
from dhg_torch import config as cf
from dhg_torch import eval as ev
from dhg_torch import metrics
from dhg_torch import train as tr
from dhg_torch.data.pipeline import synthetic_cache
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.tools import average_checkpoints as avg

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

ROOT = Path(__file__).resolve().parents[1]
SYNTH = ROOT / "data" / "style_trunk_synth.npz"


def _strokes(seed, n=120):
    rng = np.random.RandomState(seed)
    s = np.concatenate([rng.randn(n, 2) * 0.8 + [0.6, 0.0],
                        (rng.rand(n, 1) < 0.1).astype(float)], axis=1)
    s[-5:, 2] = 1.0  # padding-like tail
    return s.astype(np.float32)


@pytest.mark.parametrize("width", [None, 300, 2000])
def test_rasterize_strokes_is_dhgs(width):
    for seed in range(4):
        s = _strokes(seed)
        kw = {} if width is None else {"width": width}
        ours, ref = metrics.rasterize_strokes(s, **kw), jax_metrics.rasterize_strokes(s, **kw)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    blank = np.zeros((8, 3), np.float32)  # no pen-up: nothing drawn
    assert np.array_equal(metrics.rasterize_strokes(blank), jax_metrics.rasterize_strokes(blank))


def test_stroke_stats_and_ks_match_dhg():
    gen = [_strokes(s) for s in range(6)]
    real = [_strokes(s, n=90) for s in range(10, 17)]
    ours, ref = metrics.stroke_stats(gen), jax_metrics.stroke_stats(gen)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-12)
    rng = np.random.RandomState(0)
    a, b = rng.randn(50), rng.randn(70) + 0.3
    assert abs(metrics.ks_distance(a, b) - jax_metrics.ks_distance(a, b)) <= 1e-12
    assert metrics.ks_distance([], b) == jax_metrics.ks_distance([], b) == 1.0
    assert metrics.compare_stroke_sets(gen, real) == jax_metrics.compare_stroke_sets(gen, real)


def test_frechet_distances_match_dhg():
    rng = np.random.RandomState(1)
    f1, f2 = rng.randn(40, 16), rng.randn(30, 16) * 1.3 + 0.2
    mu1, mu2 = f1.mean(0), f2.mean(0)
    c1, c2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
    ours, ref = metrics.frechet_distance(mu1, c1, mu2, c2), jax_metrics.frechet_distance(
        mu1, c1, mu2, c2)
    assert abs(ours - ref) <= 1e-6 * abs(ref) and ref > 0
    assert abs(metrics.frechet_distance(mu1, c1, mu1, c1)) < 1e-8

    def embed(pages):  # one stub embedding for both packages
        p = np.asarray(pages, np.float64)
        return np.stack([p.mean((1, 2)), p.std((1, 2)), (p < 128).mean((1, 2)),
                         p[:, :, :64].mean((1, 2))], axis=1)

    gen = [_strokes(s) for s in range(6)]
    real = [_strokes(s, n=90) for s in range(10, 16)]
    ours = metrics.frechet_style_distance(gen, real, embed, batch_size=4)
    ref = jax_metrics.frechet_style_distance(gen, real, embed, batch_size=4)
    assert abs(ours - ref) <= 1e-6 * abs(ref)


def test_style_features_run_the_port_extractor():
    pages = np.stack([metrics.rasterize_strokes(_strokes(s), width=256) for s in range(3)])
    fn = metrics.style_feature_fn(SYNTH, "cpu")
    feats = metrics.style_features(pages, fn, batch_size=2)
    assert feats.shape == (3, 1280) and np.isfinite(feats).all()
    from dhg_torch.models.style_extractor import init_style_extractor

    with torch.no_grad():
        direct = init_style_extractor(SYNTH, device="cpu")(torch.from_numpy(pages)).mean(1)
    np.testing.assert_allclose(feats, direct.numpy(), rtol=0, atol=1e-6)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)},
            "c": rng.randn(2, 2, 2).astype(np.float32)}


def test_average_trees_matches_dhg():
    trees = [_tree(s) for s in range(3)]
    for weights in (None, [1.0, 2.0, 0.5]):
        ours, ref = avg.average_trees(trees, weights), jax_avg.average_trees(trees, weights)
        for path in (("a", "w"), ("a", "b"), ("c",)):
            o, r = ours, ref
            for k in path:
                o, r = o[k], r[k]
            assert o.dtype == np.float32
            np.testing.assert_allclose(o, np.asarray(r), rtol=0, atol=1e-7)
        sd = avg.average_trees([{"x": torch.from_numpy(t["c"])} for t in trees], weights)
        assert sd["x"].dtype == torch.float32
        np.testing.assert_allclose(sd["x"].numpy(), np.asarray(ref["c"]), rtol=0, atol=1e-7)
    for bad in (([], None), (trees, [1.0]), (trees, [0.0, 0.0, 0.0])):
        with pytest.raises(ValueError):
            avg.average_trees(*bad)


def test_average_checkpoints_files_and_cli(tmp_path, capsys):
    def sd(v):
        return {"w": torch.full((2, 3), float(v)), "b": torch.tensor([v, -v], dtype=torch.float32)}

    for step, v in ((10, 1.0), (20, 3.0), (30, 8.0)):
        ck.save_checkpoint(tmp_path / f"checkpoint_{step}", sd(v), step=step,
                           ema_state_dict=sd(v / 2))
    (tmp_path / "checkpoint_last").write_bytes(b"")  # not numbered: never a source
    assert [p.name for p in avg.numbered_checkpoints(tmp_path)] == [
        "checkpoint_10", "checkpoint_20", "checkpoint_30"]
    assert [p.name for p in avg.numbered_checkpoints(tmp_path, last=2)] == [
        "checkpoint_20", "checkpoint_30"]
    avg.main(["--dst", str(tmp_path / "soup"), "--experiment_path", str(tmp_path), "--last", "2"])
    assert "mean of 2 checkpoints, 8 params (+ema)" in capsys.readouterr().out
    soup = ck.load_checkpoint(tmp_path / "soup")
    assert torch.equal(soup["state_dict"]["w"], torch.full((2, 3), 5.5))
    assert torch.equal(soup["ema_state_dict"]["b"], torch.tensor([2.75, -2.75]))
    ck.save_checkpoint(tmp_path / "no_ema", sd(5.0))
    out = avg.average_checkpoints([tmp_path / "checkpoint_10", tmp_path / "no_ema"],
                                  tmp_path / "mixed", weights=[3.0, 1.0])
    assert "ema_state_dict" not in out and "ema_state_dict" not in ck.load_checkpoint(
        tmp_path / "mixed")
    assert torch.equal(out["state_dict"]["w"], torch.full((2, 3), 2.0))
    with pytest.raises(ValueError, match="at least two"):
        avg.average_checkpoints([tmp_path / "no_ema"], tmp_path / "x")
    with pytest.raises(SystemExit):
        avg.main(["--dst", str(tmp_path / "y")])


def _tiny_cfg(tmp_path, **ta):
    return cf.DLConfig({
        "experiment": {"name": "t", "work_dir": str(tmp_path), "seed": 2},
        "dataset_args": {"max_seq_len": 32, "max_text_len": 14},
        "optimizer": {"type": "torch.optim.Adam"},
        "training_args": {"dataset": "synthetic", "max_files": 20, "channels": 16,
                          "att_layers_num": 1, "batch_size": 4, "warmup_steps": 10,
                          "steps": 2, "log_freq": 2, "save_freq": 2,
                          "compute_dtype": "float32", **ta}})


def test_evaluate_is_the_sample_weighted_mean_of_eval_batch(tmp_path):
    model = DiffusionModel.from_config({"channels": 16, "att_layers_num": 1}, device="cpu", seed=0)
    cache = synthetic_cache(n=11, max_seq_len=32, max_text_len=14, seed=5)
    got = ev.evaluate(model, cache, batch_size=4, seed=3, n_levels=4)
    levels = ev.eval_levels(4)
    rows, weights = [], []
    for i in (0, 4, 8):
        sl = slice(i, min(i + 4, 11))
        strokes3 = torch.as_tensor(cache.strokes[sl])
        gen = torch.Generator("cpu").manual_seed(3 * 1_000_003 + i)
        eps = torch.randn(strokes3[..., :2].shape, generator=gen)
        rows.append(ev.eval_batch(model.eval(), strokes3, torch.as_tensor(cache.text[sl]).long(),
                                  torch.as_tensor(cache.style[sl]), eps, levels).numpy())
        weights.append(sl.stop - sl.start)
    want = (np.stack(rows) * np.asarray(weights)[:, None]).sum(0) / 11
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert weights == [4, 4, 3]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("runs")
    trainer = tr.main(_tiny_cfg(work, ema_decay=0.9), device="cpu")
    return trainer.exp_dir


def test_eval_cli_prints_the_val_line(tiny_run, capsys):
    got = ev.main([f"--experiment_path={tiny_run}", "--device=cpu", "--batch_size=8"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"Val Loss: {got[0]:.3f} | Val Score: {got[1]:.3f} | Val Pen: {got[2]:.3f}"
    cfg = cf.DLConfig.load(tiny_run / "config.yml")
    model = DiffusionModel.load(tiny_run / "model_final", use_ema=True, device="cpu")
    want = ev.evaluate(model, tr.load_cache(cfg, "validation", "cpu"), batch_size=8)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="config_path and checkpoint_path"):
        ev.evaluate_checkpoint(config_path=str(tiny_run / "config.yml"), device="cpu")


def test_metrics_cli_scores_a_run(tiny_run, capsys, monkeypatch):
    monkeypatch.setattr(metrics, "style_feature_fn",
                        lambda sw=None, device="cuda": lambda x: np.asarray(x).mean(1)[:, :32])
    out = metrics.main([f"--experiment_path={tiny_run}", "--device=cpu", "--n_samples=5",
                        "--batch_size=3", "--n_steps=2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["n"] == 5 and out["sampler"] == {"diffusion_mode": "new", "n_steps": 2,
                                                "schedule": "strided"}
    assert np.isfinite(list(out["ks"].values())).all() and set(out["ks"]) == set(
        jax_metrics.compare_stroke_sets([_strokes(0)], [_strokes(1)]))
    assert np.isfinite(out["frechet_style_distance"]) and "fsd_real_vs_real" in out
    cfg = cf.DLConfig.load(tiny_run / "config.yml").to_dict()
    cfg["training_args"]["distilled_steps"] = 15
    student = tiny_run.parent / "student"
    student.mkdir()
    cf.DLConfig(cfg).dump(student / "config.yml")
    (student / "model_final").write_bytes((tiny_run / "model_final").read_bytes())
    out = metrics.evaluate_generation(str(student), n_samples=2, fsd=False, device="cpu")
    assert out["sampler"] == {"diffusion_mode": "ddim", "n_steps": 15, "schedule": "halved"}


def test_cli_entry_points_refuse_the_cpu_by_default(tiny_run):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for call in (lambda: ev.evaluate_checkpoint(experiment_path=str(tiny_run)),
                 lambda: metrics.evaluate_generation(str(tiny_run), n_samples=2),
                 lambda: metrics.style_feature_fn(SYNTH)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
