"""The port's three converter CLIs against dhg's, on the CPU.

  * convert_torchvision_mnv2: a torchvision-layout MobileNetV2 `features`
    trunk (seeded, BatchNorm statistics drawn as in
    tests/test_mnv2_torch_parity.py) through the port's `convert` and dhg's:
    the same keys, arrays equal bit for bit; the CLI from a .pth and from an
    .npz; the written file loaded strictly by init_style_extractor, whose
    [2, 14, 1280] vectors match the trunk followed by the reference pooling
    at dhg's bar (rtol 1e-3, atol 1e-4).
  * convert_torch_checkpoint: the reference's container, a bare state_dict
    and a `module.`-prefixed one give state_dict_from_dhg(dhg's
    convert_state_dict(sd)) bit for bit, which DiffusionModel.load and the
    infer CLI read; a missing key raises KeyError in both packages.
  * export_torch_checkpoint: the EMA weights preferred, dhg's
    export_state_dict(params) bit for bit, only `meta` and `state_dict` in
    the file with dhg's meta fields, and --experiment_path resolved in
    dhg's order; export followed by convert gives the weights back.
  * The three parsers carry dhg's flags, defaults and groups.

dhg's converters are numpy-only: no dhg model is initialised or applied
here, so nothing compiles.
"""

import argparse
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from dhg.checkpoint import resolve_checkpoint as dhg_resolve_checkpoint
from dhg.tools import convert_torch_checkpoint as dhg_ckpt_convert
from dhg.tools import convert_torchvision_mnv2 as dhg_mnv2
from dhg.tools import export_torch_checkpoint as dhg_export
from dhg_torch import inference as tinf
from dhg_torch.checkpoint import save_checkpoint
from dhg_torch.data.images import write_png
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS
from dhg_torch.models.style_extractor import init_style_extractor
from dhg_torch.tools import convert_torch_checkpoint as ckpt_convert
from dhg_torch.tools import convert_torchvision_mnv2 as mnv2
from dhg_torch.tools import export_torch_checkpoint as export
from dhg_torch.weights import state_dict_from_dhg
from test_torch_checkpoint_convert import _fake_reference_state_dict
from test_torch_port_common import C1, N_LAYERS, random_params

SYNTH = Path(__file__).resolve().parents[1] / "data" / "style_trunk_synth.npz"


# -- a torchvision-layout MobileNetV2 trunk -------------------------------------------


def _conv_bn_relu(cin, cout, k, stride=1, groups=1):
    """torchvision's Conv2dNormActivation: Conv2d(bias=False), BN, ReLU6."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, groups=groups, bias=False),
        nn.BatchNorm2d(cout), nn.ReLU6(inplace=True))


class _InvertedResidual(nn.Module):
    """torchvision's InvertedResidual with its child names."""

    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        layers = [_conv_bn_relu(cin, hidden, 1)] if expand != 1 else []
        layers += [_conv_bn_relu(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), nn.BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class TorchvisionFeatures(nn.Module):
    """torchvision's mobilenet_v2().features, so that state_dict() carries
    the published `features.N...` names."""

    def __init__(self):
        super().__init__()
        feats, cin = [_conv_bn_relu(3, 32, 3, stride=2)], 32
        for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
            for i in range(n):
                feats.append(_InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        feats.append(_conv_bn_relu(cin, 1280, 1))
        self.features = nn.Sequential(*feats)

    def forward(self, x):
        return self.features(x)


def torchvision_trunk(seed: int) -> TorchvisionFeatures:
    """The trunk in eval mode: torch's init under `seed`, every BatchNorm's
    weight, bias and running statistics drawn as dhg's parity test draws
    them."""
    rng = np.random.RandomState(seed)
    torch.manual_seed(seed)
    net = TorchvisionFeatures().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5))
                m.bias.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1))
                m.running_mean.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.2))
                m.running_var.copy_(torch.from_numpy(rng.rand(n).astype(np.float32) + 0.3))
    return net


def reference_style(net, img: np.ndarray) -> np.ndarray:
    """The reference StyleExtractor's forward on the trunk: [-1, 1], 3
    channels, AvgPool2d(3, 3), AdaptiveAvgPool2d((1, 14)), channels last."""
    with torch.no_grad():
        x = (torch.from_numpy(img[:, None]) / 127.5 - 1).repeat(1, 3, 1, 1)
        x = nn.AdaptiveAvgPool2d((1, 14))(nn.AvgPool2d(3, 3)(net(x)))
        return x.squeeze(2).permute(0, 2, 1).numpy()


@pytest.fixture(scope="module")
def trunk(tmp_path_factory):
    """The trunk, its state_dict saved as torchvision's file holds it (the
    `classifier.1` Linear beside `features`) to .pth and .npz, and dhg's
    conversion of it."""
    root = tmp_path_factory.mktemp("mnv2")
    net = torchvision_trunk(2)
    sd = dict(net.state_dict())
    sd["classifier.1.weight"] = torch.randn(1000, 1280, generator=torch.Generator().manual_seed(2))
    sd["classifier.1.bias"] = torch.zeros(1000)
    torch.save(sd, root / "mnv2.pth")
    np.savez(root / "mnv2.npz", **{k: v.numpy() for k, v in sd.items()})
    return root, net, dhg_mnv2.convert({k: v.numpy() for k, v in sd.items()})


def assert_flat_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_mnv2_convert_matches_dhg(trunk):
    _, net, want = trunk
    assert len(want) == 260  # 52 convs, each with its BatchNorm
    assert_flat_equal(mnv2.convert({k: v.numpy() for k, v in net.state_dict().items()}), want)


@pytest.mark.parametrize("suffix", ["pth", "npz"])
def test_mnv2_cli(trunk, suffix, capsys):
    root, _, want = trunk
    dst = root / f"from_{suffix}.npz"
    mnv2.main([f"--src={root / f'mnv2.{suffix}'}", f"--dst={dst}"])
    assert capsys.readouterr().out == f"wrote {dst} ({len(want)} arrays)\n"
    with np.load(dst) as f:
        assert_flat_equal(dict(f), want)


def test_mnv2_converted_file_matches_the_torchvision_trunk(trunk):
    root, net, _ = trunk
    dst = root / "style.npz"
    mnv2.main([f"--src={root / 'mnv2.pth'}", f"--dst={dst}"])
    extractor = init_style_extractor(weights_path=dst, strict=True, device="cpu")
    img = (np.random.RandomState(2).rand(2, 96, 200) * 255).astype(np.float32)
    with torch.no_grad():
        ours = extractor(torch.from_numpy(img)).numpy()
    want = reference_style(net, img)
    assert ours.shape == want.shape == (2, 14, 1280)
    np.testing.assert_allclose(ours, want, rtol=1e-3, atol=1e-4)


def test_mnv2_missing_key_raises_as_in_dhg(trunk):
    _, net, _ = trunk
    sd = {k: v.numpy() for k, v in net.state_dict().items()
          if k != "features.5.conv.1.1.running_var"}
    with pytest.raises(KeyError, match="features.5.conv.1.1.running_var"):
        dhg_mnv2.convert(sd)
    with pytest.raises(KeyError, match=r"features\.5\.conv\.1\.1\.running_var"):
        mnv2.convert(sd)


def test_missing_style_weights_name_the_ports_converter(tmp_path):
    with pytest.warns(UserWarning, match=r"python -m dhg_torch\.tools\.convert_torchvision_mnv2"):
        init_style_extractor(weights_path=tmp_path / "absent.npz", device="cpu")


# -- the parsers ---------------------------------------------------------------------------


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _parser(main, monkeypatch):
    """The ArgumentParser that `main` builds, caught at its parse_args."""
    def catch(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as caught:
        main()
    parser = caught.value.parser
    actions = sorted((a.option_strings, a.dest, a.default, a.required, a.nargs)
                     for a in parser._actions)
    groups = sorted((sorted(a.dest for a in g._group_actions), g.required)
                    for g in parser._mutually_exclusive_groups)
    flags = {a.dest: a.type for a in parser._actions}
    return actions, groups, flags


@pytest.mark.parametrize("port,dhg", [(mnv2, dhg_mnv2), (ckpt_convert, dhg_ckpt_convert),
                                      (export, dhg_export)],
                         ids=["convert_torchvision_mnv2", "convert_torch_checkpoint",
                              "export_torch_checkpoint"])
def test_flags_match_dhg(port, dhg, monkeypatch):
    ours, ours_groups, ours_types = _parser(port.main, monkeypatch)
    want, want_groups, want_types = _parser(dhg.main, monkeypatch)
    assert ours == want and ours_groups == want_groups
    if "use_ema" in want_types:
        for s in ("true", "True", "1", "false", "False", "0", "no", "yes"):
            assert ours_types["use_ema"](s) == want_types["use_ema"](s), s


# -- convert_torch_checkpoint ------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return random_params(seed=5)


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def assert_state_dicts_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("form", ["container", "bare", "module", "full_width"])
def test_convert_torch_checkpoint_matches_dhg(params, form, tmp_path, capsys):
    ref = _fake_reference_state_dict() if form == "full_width" else dhg_export.export_state_dict(
        params)
    if form == "module":
        ref = {f"module.{k}": v for k, v in ref.items()}
    want = state_dict_from_dhg(dhg_ckpt_convert.convert_state_dict(ref))
    src, dst = tmp_path / "ref.pth", tmp_path / "converted"
    sd = _tensors(ref)
    torch.save(sd if form in ("bare", "module") else {"meta": {"epoch": 3}, "state_dict": sd},
               src)
    ckpt_convert.main([f"--src={src}", f"--dst={dst}"])
    n = sum(v.numel() for v in want.values())
    assert capsys.readouterr().out == f"wrote {dst}: {n} params\n"
    saved = torch.load(dst, map_location="cpu", weights_only=True)
    assert set(saved) == {"meta", "state_dict"}
    assert_state_dicts_equal(saved["state_dict"], want)
    model = DiffusionModel.load(dst, device="cpu")
    assert model.c1 == (128 if form == "full_width" else C1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("missing", ["enc4.fc.weight", "enc4.fc.bias"])
def test_convert_torch_checkpoint_names_a_missing_key(params, missing, tmp_path):
    """dhg's converter takes a Linear without its bias, which its bridge to
    the port then refuses; the port's converter refuses either at once."""
    ref = dhg_export.export_state_dict(params)
    del ref[missing]
    torch.save(_tensors(ref), tmp_path / "ref.pth")
    with pytest.raises(KeyError):
        state_dict_from_dhg(dhg_ckpt_convert.convert_state_dict(ref))
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        ckpt_convert.main([f"--src={tmp_path / 'ref.pth'}", f"--dst={tmp_path / 'out'}"])
    assert not (tmp_path / "out").exists()


def test_infer_reads_the_converted_checkpoint(params, tmp_path):
    """The infer CLI on the converted file and a --config_path gives the strokes
    it gives on the reference container itself (which the port reads)."""
    src = tmp_path / "ref.pth"
    torch.save({"meta": {}, "state_dict": _tensors(dhg_export.export_state_dict(params))}, src)
    ckpt_convert.main([f"--src={src}", f"--dst={tmp_path / 'converted'}"])
    cfg = tmp_path / "config.yml"
    cfg.write_text(json.dumps({
        "training_args": {"channels": C1, "att_layers_num": N_LAYERS},
        "dataset_args": {"max_text_len": 4, "style_weights": str(SYNTH)}}))
    rng = np.random.RandomState(4)
    page = np.full((60, 200), 235, np.uint8)
    for _ in range(12):
        r, c = rng.randint(5, 55), rng.randint(5, 180)
        page[r - 2:r + 2, c:c + rng.randint(4, 18)] = rng.randint(0, 60)
    write_png(tmp_path / "style.png", page)
    strokes = {
        name: tinf.main(["--prompt=ab", f"--source={tmp_path / 'style.png'}",
                         f"--checkpoint_path={tmp_path / name}", f"--config_path={cfg}",
                         f"--output={tmp_path / name}_out", "--format=svg", "--n_steps=3",
                         "--device=cpu"])
        for name in ("converted", "ref.pth")}
    assert strokes["converted"].shape[1] == 3 and np.isfinite(strokes["converted"]).all()
    np.testing.assert_array_equal(strokes["converted"], strokes["ref.pth"])


# -- export_torch_checkpoint -------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory, params):
    """A run dir of the port's trainer: model_final with raw and EMA weights
    (params and ema params), checkpoint_7 with a step and optimizer state
    and no EMA."""
    root = tmp_path_factory.mktemp("run")
    ema = random_params(seed=6)
    save_checkpoint(root / "model_final", state_dict_from_dhg(params),
                    ema_state_dict=state_dict_from_dhg(ema))
    save_checkpoint(root / "checkpoint_7", state_dict_from_dhg(params), step=7,
                    optimizer={"state": {0: {"exp_avg": torch.ones(3)}}})
    return root, ema


@pytest.mark.parametrize("use_ema", [None, "false"])
def test_export_prefers_the_ema(run, params, use_ema, tmp_path, capsys):
    root, ema = run
    dst = tmp_path / "out.pth"
    argv = [f"--src={root / 'model_final'}", f"--dst={dst}"]
    export.main(argv + ([f"--use_ema={use_ema}"] if use_ema else []))
    used = use_ema is None
    want = _tensors(dhg_export.export_state_dict(ema if used else params))
    saved = torch.load(dst, map_location="cpu", weights_only=True)
    assert list(saved) == ["meta", "state_dict"]
    assert saved["meta"] == {"exported_by": "dhg_torch.tools.export_torch_checkpoint",
                             "source_checkpoint": str(root / "model_final"), "ema": used}
    assert_state_dicts_equal(saved["state_dict"], want)
    n = sum(v.numel() for v in want.values())
    assert capsys.readouterr().out == (f"wrote {dst}: {len(want)} tensors, {n} params "
                                       f"(ema={used})\n")


def test_export_of_a_numbered_checkpoint_carries_its_step(run, params, tmp_path):
    root, _ = run
    export.main([f"--src={root / 'checkpoint_7'}", f"--dst={tmp_path / 'out.pth'}"])
    saved = torch.load(tmp_path / "out.pth", map_location="cpu", weights_only=True)
    assert list(saved) == ["meta", "state_dict"]
    assert saved["meta"]["step"] == 7 and saved["meta"]["ema"] is False
    assert_state_dicts_equal(saved["state_dict"],
                             _tensors(dhg_export.export_state_dict(params)))


@pytest.mark.parametrize("present,want", [
    (["checkpoint_2", "checkpoint_10"], "checkpoint_10"),
    (["checkpoint_2", "checkpoint_10", "model_last"], "model_last"),
    (["checkpoint_10", "model_last", "model_final"], "model_final"),
])
def test_export_discovers_in_dhgs_order(params, present, want, tmp_path):
    sd = state_dict_from_dhg(params)
    for name in present:
        save_checkpoint(tmp_path / name, sd)
    assert dhg_resolve_checkpoint(tmp_path) == tmp_path / want
    export.main([f"--experiment_path={tmp_path}", f"--dst={tmp_path / 'out.pth'}"])
    saved = torch.load(tmp_path / "out.pth", map_location="cpu", weights_only=True)
    assert saved["meta"]["source_checkpoint"] == str(tmp_path / want)


def test_export_without_a_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint found"):
        export.main([f"--experiment_path={tmp_path}", f"--dst={tmp_path / 'out.pth'}"])


def test_export_then_convert_gives_the_weights_back(run, tmp_path):
    root, ema = run
    export.main([f"--experiment_path={root}", f"--dst={tmp_path / 'out.pth'}"])
    ckpt_convert.main([f"--src={tmp_path / 'out.pth'}", f"--dst={tmp_path / 'back'}"])
    back = torch.load(tmp_path / "back", map_location="cpu", weights_only=True)["state_dict"]
    assert_state_dicts_equal(back, state_dict_from_dhg(ema))
