"""The port's `infer` front end against dhg's, end to end on the CPU, in f32.

(f) The same random weights go into a dhg run dir (orbax model_final) and a
port run dir (its own model_final); both `infer`s read the same style PNG
through data/style_trunk_synth.npz and sample with the same randomness:
dhg's jax.random draws for PRNGKey(seed) are handed to the port by
monkeypatching dhg_torch.inference.generate, so `infer` itself takes no
argument dhg lacks. Bar: stroke MSE < 1e-3 (the sampler's bar), for one
prompt, a prompts_file and wrap. The three calls share one shape (one
line of 2 characters, max_text_len 3), so dhg compiles its sampler once.
dhg's extractor is seeded into its memo with the .npz variables, which
skips the random init it would compile first.

Also: the port reads its own run dir's config.yml without PyYAML.
"""

import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import dhg.inference as jinf
from dhg.checkpoint import save_checkpoint as jax_save_checkpoint
from dhg.models.style_extractor import StyleExtractor as JaxStyleExtractor
from dhg_torch import inference as tinf
from dhg_torch.checkpoint import save_checkpoint
from dhg_torch.config import DLConfig
from dhg_torch.data.images import read_png, write_png
from dhg_torch.weights import state_dict_from_dhg
from test_torch_port_common import random_params
from test_torch_port_style import SYNTH, _line_image

C1, N_LAYERS = 16, 1  # small: dhg's sampler compile is most of this file's time
CFG = {"training_args": {"channels": C1, "att_layers_num": N_LAYERS},
       "dataset_args": {"max_text_len": 3, "max_seq_len": 64, "style_weights": str(SYNTH)}}


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    params = random_params(seed=13, c1=C1, num_layers=N_LAYERS)
    jdir, tdir = root / "dhg_run", root / "port_run"
    for d in (jdir, tdir):
        d.mkdir()
        (d / "config.yml").write_text(yaml.safe_dump(CFG))
    jax_save_checkpoint(jdir / "model_final", params)
    save_checkpoint(tdir / "model_final", state_dict_from_dhg(params))
    write_png(root / "style.png", _line_image(np.random.RandomState(4)))
    (root / "prompts.txt").write_text("hi\n\n")
    return root, jdir, tdir


@pytest.fixture
def shared_draws(monkeypatch):
    """dhg's extractor memo seeded with the .npz weights; the port's
    generate fed dhg's draws for PRNGKey(seed)."""
    with np.load(SYNTH) as f:
        variables = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in f.items()})
    apply = jax.jit(lambda img: JaxStyleExtractor().apply(variables, img))
    monkeypatch.setitem(jinf._style_extractors, (str(SYNTH), False), apply)
    real = tinf.generate
    seed = {}

    def generate(model, text, style, generator=None, seq_len=None, **kw):
        k_init, k_steps = jax.random.split(jax.random.PRNGKey(seed["value"]))
        b, n = text.shape[0], kw.get("n_steps") or 60
        x0 = jax.random.normal(k_init, (b, seq_len, 2))
        noises = jax.vmap(lambda k: jax.random.normal(k, (b, seq_len, 2)))(
            jax.random.split(k_steps, n))
        return real(model, text, style, seq_len=seq_len, x_init=torch.from_numpy(np.array(x0)),
                    noises=torch.from_numpy(np.array(noises)), **kw)

    monkeypatch.setattr(tinf, "generate", generate)
    return seed


@pytest.mark.parametrize("mode", ["prompt", "prompts_file", "wrap"])
def test_infer_matches_dhg(run_dirs, shared_draws, mode):
    root, jdir, tdir = run_dirs
    seed = {"prompt": 1, "prompts_file": 2, "wrap": 3}[mode]
    shared_draws["value"] = seed
    kw = dict(source=str(root / "style.png"), seed=seed, format="svg")
    if mode == "prompts_file":
        kw["prompts_file"] = str(root / "prompts.txt")
    else:
        kw["prompt"] = "hi"
    if mode == "wrap":
        kw["wrap"] = 2
    ref = jinf.infer(experiment_path=str(jdir), output=str(root / f"dhg_{mode}"), **kw)
    ours = tinf.infer(experiment_path=str(tdir), output=str(root / f"port_{mode}"),
                      device="cpu", **kw)
    if mode == "prompts_file":
        assert len(ours) == len(ref) == 1
        ours, ref = ours[0], ref[0]
        assert (root / "port_prompts_file_000.svg").is_file()
    else:
        assert (root / f"port_{mode}.svg").is_file()
    assert ours.shape == np.asarray(ref).shape and np.isfinite(ours).all()
    mse = float(np.mean((ours - np.asarray(ref)) ** 2))
    assert mse < 1e-3, mse


def test_main_writes_png(run_dirs, monkeypatch):
    """The CLI on the port's run dir: a PNG that the port's reader decodes."""
    root, _, tdir = run_dirs
    monkeypatch.chdir(root)
    tinf.main(["--prompt=ab", f"--source={root / 'style.png'}", f"--experiment_path={tdir}",
               "--output=cli", "--n_steps=3", "--device=cpu"])
    img = read_png(root / "cli.png")
    assert img.dtype == np.uint8 and img.shape[0] > 0
    with pytest.raises(ValueError, match="exactly one"):
        tinf.infer(experiment_path=str(tdir), source=str(root / "style.png"), device="cpu")


def test_config_round_trip_without_yaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = DLConfig({"training_args": {"channels": 8, "distilled_steps": 30},
                    "dataset_args": {"max_text_len": 50}})
    cfg.dump(tmp_path / "config.yml")
    back = DLConfig.load(tmp_path / "config.yml")
    assert back.to_dict() == cfg.to_dict()
    assert back.training_args.distilled_steps == 30 and back.dataset_args.style_weights is None
    (tmp_path / "plain.yml").write_text("a: 1\n")
    with pytest.raises(RuntimeError, match="PyYAML"):
        DLConfig.load(tmp_path / "plain.yml")
