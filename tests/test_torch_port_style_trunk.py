"""The port's random inits and its style-trunk trainer
(dhg_torch/tools/train_style_trunk.py) against dhg's, on the CPU.

(a) The random MobileNetV2: features of the random trunk on the same 4
lines, seeds 0-2 on each side, mean std within [0.5, 2] x dhg's; each conv
kernel of >= 256 values within 10% of dhg's std for the same name. (b)
The denoiser's init, parameter by parameter, against dhg/ops/init.py's
formulas as dhg's modules apply them. (c) render_line_fast against dhg's
cv2 renderer: ink coverage within 10%, >= 97% of pixels on the same side
of grey 128. (d) warmup_cosine_decay against optax's at every count. (e)
Three training steps of the port against dhg's loss_fn / optax chain
(rebuilt here: they are closures in dhg) from the same weights on the same
batches, the port's steps taken by TrunkStep (the replayed step's body,
eager on the CPU): CE per step within 1e-5 relative, features after within
1e-4; the saved .npz loads strict in dhg and gives its features within
1e-4. (f) build_tree_training_set against dhg's on a tiny generated tree.
dhg's side runs under jax.jit, waited on before the port's work.
"""

from pathlib import Path

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dhg.models.style_extractor import StyleExtractor as JaxStyleExtractor
from dhg_torch.models.style_extractor import init_style_extractor
from dhg_torch.tools import train_style_trunk as tst
from dhg_torch.tools.eval_style_gap import render_line

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

SYNTH = Path(__file__).resolve().parents[1] / "data" / "style_trunk_synth.npz"
MISSING = "/nonexistent/force_random.npz"


def _quiet_port_extractor(path, seed=0):
    with pytest.warns(UserWarning, match="RANDOM-INITIALIZED"):
        return init_style_extractor(path, seed=seed, device="cpu")


# -- (a) the random MobileNetV2 -----------------------------------------------


def test_random_trunk_matches_dhg_scale():
    imgs = np.stack([render_line(w, w * 131 + k, 128) for w in (0, 5) for k in range(2)])
    model = JaxStyleExtractor()
    init = jax.jit(model.init)
    apply = jax.jit(model.apply)
    dhg_vars = [init(jax.random.PRNGKey(s), jnp.zeros((1, 96, 192), jnp.float32))
                for s in range(3)]
    dhg_std = [float(jax.block_until_ready(apply(v, imgs)).std()) for v in dhg_vars]
    port = [_quiet_port_extractor(MISSING, seed=s) for s in range(3)]
    with torch.no_grad():
        port_std = [float(m(torch.from_numpy(imgs)).std()) for m in port]
    ratio = np.mean(port_std) / np.mean(dhg_std)
    assert 0.5 <= ratio <= 2.0, (port_std, dhg_std)

    flat = flax.traverse_util.flatten_dict(dhg_vars[0], sep="/")
    sd = port[0].state_dict()
    checked = 0
    for name, w in sd.items():
        *path, leaf = name.split(".")
        if leaf != "weight" or path[-1] not in ("conv", "project") or w.numel() < 256:
            continue
        ref = float(np.asarray(flat[f"params/{'/'.join(path)}/kernel"]).std())
        assert abs(float(w.std()) / ref - 1) <= 0.10, (name, float(w.std()), ref)
        checked += 1
    assert checked == 52  # every conv of the trunk


# -- (b) the denoiser's init against dhg/ops/init.py ---------------------------


def test_denoiser_init_follows_dhg():
    """Each parameter of the port's denoiser (c1 = 32) against the
    initialiser dhg's module gives it (dhg/ops/init.py): kernels
    U(+-1/sqrt(fan_in)), fan_in the product of dhg's kernel shape but its
    last axis (the port's weight[0]); biases the same bound at the layer's
    fan_in (dense(features, in_features), the k3 convs, MultiHeadAttention's
    d_model: its inputs' width), but FiLM gamma biases 1
    (nn.initializers.ones) and FiLM beta biases at SIGMA_EMB_DIM;
    embeddings N(0, 1). Tensors of >= 256 values: std within 10% of the
    formula's; all: inside the bound, and pooled by bound within 10%."""
    from dhg.ops.basic import SIGMA_EMB_DIM
    from dhg_torch.models.denoiser import DiffusionModel

    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 2}, device="cpu",
                                       seed=0)
    params = dict(model.named_parameters())
    pooled: dict[float, list] = {}
    for name, p in params.items():
        module, leaf = name.rsplit(".", 1)
        x = p.detach().double().numpy().ravel()
        if module.endswith("text_style_model.emb"):
            kind, scale = "normal", 1.0
        elif leaf == "bias" and module.endswith("gamma_emb"):
            assert np.all(x == 1.0), name
            continue
        elif leaf == "bias" and module.endswith("beta_emb"):
            kind, scale = "uniform", 1.0 / np.sqrt(SIGMA_EMB_DIM)
        else:  # kernel, or its own layer's bias: fan_in from the weight
            kind, scale = "uniform", 1.0 / np.sqrt(params[f"{module}.weight"][0].numel())
        if kind == "uniform":
            assert np.abs(x).max() <= scale, name
            pooled.setdefault(scale, []).append(x)
            want = scale / np.sqrt(3.0)
        else:
            want = scale
        if x.size >= 256:
            assert abs(x.std() / want - 1) <= 0.10, (name, x.std(), want)
    for bound, xs in pooled.items():  # the small tensors, pooled by bound
        x = np.concatenate(xs)
        assert abs(x.std() / (bound / np.sqrt(3.0)) - 1) <= 0.10, (bound, x.size)


def test_film_beta_bias_bound_is_dhgs_at_a_narrow_sigma_embedding():
    """dhg's FiLM beta bias bound is 1/sqrt(SIGMA_EMB_DIM) whatever the
    sigma embedding's width: here 8 (c1 = 32), where torch's rule would
    give 1/sqrt(8)."""
    from dhg.ops.basic import SIGMA_EMB_DIM, AffineTransformLayer
    from dhg_torch.models.denoiser import DiffusionModel

    variables = jax.jit(AffineTransformLayer(512).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 512)), jnp.zeros((1, 8)))
    dhg_bias = np.asarray(variables["params"]["beta_emb"]["bias"])
    port = DiffusionModel.from_config({"channels": 32, "att_layers_num": 1}, device="cpu", seed=0)
    port_bias = np.concatenate([m.beta_emb.bias.detach().numpy()
                                for m in port.modules() if hasattr(m, "beta_emb")])
    bound = 1.0 / np.sqrt(SIGMA_EMB_DIM)
    for b in (dhg_bias, port_bias):
        assert 0.9 * bound < np.abs(b).max() <= bound


# -- (c) render_line_fast against dhg's cv2 renderer ---------------------------


@pytest.mark.parametrize("writer", range(100, 108))
def test_render_line_fast_matches_cv2(writer):
    from dhg.tools.train_style_trunk import render_line_fast as cv2_render

    seed = writer * 977
    ref, ours = cv2_render(writer, seed, 384), tst.render_line_fast(writer, seed, 384)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape == (96, 384)
    ink_ref, ink = ref < 128, ours < 128
    assert abs(ink.mean() / ink_ref.mean() - 1) <= 0.10
    assert (ink == ink_ref).mean() >= 0.97


# -- (d) the schedule ------------------------------------------------------------


@pytest.mark.parametrize("steps", [30, 60, 600])
def test_warmup_cosine_decay_matches_optax(steps):
    from dhg_torch.train import warmup_cosine_decay

    lr = 3e-4
    try:
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, 50, steps)
    except ValueError:
        with pytest.raises(ValueError, match="positive decay_steps"):
            warmup_cosine_decay(0.0, lr, 50, steps)
        assert steps <= 50
        return
    counts = np.arange(steps + 10, dtype=np.int32)
    want = np.asarray(jax.block_until_ready(jax.jit(jax.vmap(ref))(counts)))
    ours = warmup_cosine_decay(0.0, lr, 50, steps)
    got = np.array([ours(int(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * lr)
    assert got[0] == 0.0 and got[-1] == 0.0


# -- (e) three training steps against dhg ----------------------------------------

N_CLASSES, WIDTH, LR, SCHEDULE_STEPS = 3, 96, 0.05, 60


class _DhgHead(fnn.Module):
    """dhg/tools/train_style_trunk.py's Head (a closure there)."""

    n_classes: int

    @fnn.compact
    def __call__(self, feats):
        h = feats.mean(axis=1)
        h = h / (jnp.linalg.norm(h, axis=-1, keepdims=True) + 1e-6)
        return fnn.Dense(self.n_classes, name="cls")(h * 16.0)


@pytest.fixture(scope="module")
def three_steps(tmp_path_factory):
    """Both packages' 3 steps from data/style_trunk_synth.npz and one numpy
    head, batches of 4 from a 3-writer set (width 96), lr 0.05 under the
    60-step schedule (counts 0, 1, 2: lr 0, 1e-3, 2e-3)."""
    imgs, labels = tst.build_training_set(N_CLASSES, 4, WIDTH)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, len(imgs), 4) for _ in range(3)]
    probe = imgs[[0, 5, 9]].astype(np.float32)
    with np.load(SYNTH) as f:
        flat = dict(f)
    kernel = (rng.randn(1280, N_CLASSES) / np.sqrt(1280)).astype(np.float32)

    # dhg: train() :204-247, with the batches handed in.
    variables = flax.traverse_util.unflatten_dict({tuple(k.split("/")): v
                                                   for k, v in flat.items()})
    extractor, head = JaxStyleExtractor(), _DhgHead(N_CLASSES)
    ext_stats = variables["batch_stats"]
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(optax.warmup_cosine_decay_schedule(0.0, LR, 50, SCHEDULE_STEPS)))
    trainable = (variables["params"],
                 {"cls": {"kernel": jnp.asarray(kernel), "bias": jnp.zeros(N_CLASSES)}})
    opt_state = tx.init(trainable)

    def loss_fn(trainable, x, y):
        ep, hp = trainable
        feats = extractor.apply({"params": ep, "batch_stats": ext_stats}, x)
        logits = head.apply({"params": hp}, feats)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        acc = (logits.argmax(-1) == y).mean()
        return ce, acc

    @jax.jit
    def step_fn(trainable, opt_state, x, y):
        (ce, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable, x, y)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        feats = extractor.apply({"params": trainable[0], "batch_stats": ext_stats}, probe)
        return trainable, opt_state, ce, acc, feats

    dhg_ce, dhg_acc = [], []
    for idx in batches:
        trainable, opt_state, ce, acc, feats = step_fn(
            trainable, opt_state, imgs[idx].astype(np.float32), labels[idx])
        dhg_ce.append(float(ce))
        dhg_acc.append(float(acc))
    dhg_feats = np.asarray(jax.block_until_ready(feats))

    # the port: TrunkStep (the replayed step's body, eager here) from the same weights
    extractor_t = init_style_extractor(SYNTH, device="cpu").requires_grad_(True)
    head_t = tst.Head(N_CLASSES)
    with torch.no_grad():
        head_t.cls.weight.copy_(torch.from_numpy(kernel.T))
        head_t.cls.bias.zero_()
    net = tst.TrunkClassifier(extractor_t, head_t).eval()
    step = tst.TrunkStep(net, tst.make_optimizer(net, LR, SCHEDULE_STEPS), torch.from_numpy(imgs),
                         torch.from_numpy(labels.astype(np.int64)))
    rows = [step(torch.from_numpy(idx.astype(np.int64))).tolist() for idx in batches]
    with torch.no_grad():
        port_feats = net.extractor(torch.from_numpy(probe)).numpy()
    from dhg_torch.weights import flat_from_style_state_dict

    saved = tmp_path_factory.mktemp("trunk") / "trunk.npz"
    np.savez_compressed(saved, **flat_from_style_state_dict(net.extractor.state_dict()))
    return dict(dhg_ce=dhg_ce, dhg_acc=dhg_acc, dhg_feats=dhg_feats,
                port_ce=[r[0] for r in rows], port_acc=[r[1] for r in rows],
                port_feats=port_feats, probe=probe, saved=saved, template=variables, net=net,
                step_graph=step.graph)


def test_three_train_steps_match_dhg(three_steps):
    r = three_steps
    assert r["step_graph"] is None  # no graph on the CPU: the body, eagerly
    np.testing.assert_allclose(r["port_ce"], r["dhg_ce"], rtol=1e-5)
    assert r["port_acc"] == r["dhg_acc"]
    assert np.abs(r["port_feats"] - r["dhg_feats"]).max() <= 1e-4
    # The steps moved the trunk (the features are not the starting ones).
    start = init_style_extractor(SYNTH, device="cpu")
    with torch.no_grad():
        before = start(torch.from_numpy(r["probe"])).numpy()
    assert np.abs(r["port_feats"] - before).max() > 1e-3
    # BatchNorm's running statistics did not move.
    for name, buf in r["net"].extractor.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(buf, start.state_dict()[name]), name


def test_saved_trunk_loads_strict_in_dhg_and_the_port(three_steps):
    from dhg.models.style_extractor import _fill_from_flat

    r = three_steps
    with np.load(r["saved"]) as f:
        flat = dict(f)
    want_keys = set(flax.traverse_util.flatten_dict(r["template"], sep="/"))
    assert set(flat) == want_keys
    variables = _fill_from_flat(r["template"], flat)
    dhg_feats = np.asarray(jax.block_until_ready(
        jax.jit(JaxStyleExtractor().apply)(variables, r["probe"])))
    port = init_style_extractor(r["saved"], strict=True, device="cpu")
    with torch.no_grad():
        port_feats = port(torch.from_numpy(r["probe"])).numpy()
    assert np.abs(port_feats - dhg_feats).max() <= 1e-4
    assert np.abs(port_feats - r["port_feats"]).max() == 0.0


# -- (f) the tree training set ---------------------------------------------------


def test_build_tree_training_set_matches_dhg(tmp_path):
    from dhg.tools.train_style_trunk import build_tree_training_set as dhg_build
    from dhg_torch.tools import gen_iam_scale

    gen_iam_scale.main(root=str(tmp_path), train_forms=5, val_forms=1, lines_per_form=3, seed=7)
    kw = dict(n_forms=4, width=128, holdout_forms=2, seed=3)
    want = dhg_build(str(tmp_path), **kw)
    got = tst.build_tree_training_set(str(tmp_path), **kw)
    assert len(want[0]) > 0 and len(want[2]) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
