"""The port's weight bridge against dhg's exporter: same keys, bit-exact
values, strict loads from params and from the exported .pth container."""

import numpy as np
import pytest
import torch

from dhg.tools.export_torch_checkpoint import export_state_dict
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.weights import config_from_state_dict, load_checkpoint, state_dict_from_dhg
from test_torch_port_common import C1, N_LAYERS, port_model, random_params


@pytest.fixture(scope="module")
def params():
    return random_params(seed=3)


def test_bridge_matches_exporter_key_for_key(params):
    ours = state_dict_from_dhg(params)
    ref = export_state_dict(params)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_bridge_loads_strictly(params):
    model = port_model(params)
    sd = model.state_dict()
    ref = export_state_dict(params)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_load_exported_pth(params, tmp_path):
    """The {meta, state_dict} file the exporter CLI writes loads into
    DiffusionModel.load with the config inferred; anything else is refused."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(params).items()}
    path = tmp_path / "model.pth"
    torch.save({"meta": {"ema": False}, "state_dict": sd}, path)
    meta, loaded = load_checkpoint(path)
    assert meta == {"ema": False}
    assert config_from_state_dict(loaded) == {"channels": C1, "att_layers_num": N_LAYERS}
    model = DiffusionModel.load(path, device="cpu")
    assert (model.c1, model.c2, model.c3, model.num_layers) == (C1, 48, 64, N_LAYERS)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_load_refuses_a_bare_state_dict(params, tmp_path):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(params).items()}
    torch.save(sd, tmp_path / "bare.pth")
    with pytest.raises(ValueError, match="meta, state_dict"):
        load_checkpoint(tmp_path / "bare.pth")


def test_from_config_is_deterministic_and_loadable():
    a = DiffusionModel.from_config({"channels": C1, "att_layers_num": 1}, device="cpu", seed=7)
    b = DiffusionModel.from_config({"channels": C1, "att_layers_num": 1}, device="cpu", seed=7)
    c = DiffusionModel.from_config({"channels": C1, "att_layers_num": 1}, device="cpu", seed=8)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    gammas = [k for k in sa if k.endswith("gamma_emb.bias")]
    assert gammas and all(torch.all(sa[k] == 1.0) for k in gammas)
