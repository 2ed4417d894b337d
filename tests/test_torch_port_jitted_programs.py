"""dhg's last jitted programs in the port, on the CPU (no graph here; the
replays are held to these eager paths on the card by
test_torch_port_jitted_programs_cuda.py): the StyleExtractor's apply_fn
(style_extractor.make_apply_fn) is the module call bit for bit, at B = 1
and 3 on 96 x 128 images, and its width bins are built on the device as
they were on the host; the Jacobi sampler on an x_T drawn as it draws it
(eval_parallel_sampler's replayed path) equals the sampler drawing it
itself, bit for bit, with every sweep. The style trunk's step body is in
test_torch_port_style_trunk.py, profile_stages' report in
test_torch_port_tools.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch.core.parallel_sampling import parallel_ddim_sample
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.models.style_extractor import (STYLE_LEN, init_style_extractor, make_apply_fn,
                                              width_bins)

torch.set_num_threads(1)  # tiny tensors: see test_torch_port_common.py

SYNTH = Path(__file__).resolve().parents[1] / "data" / "style_trunk_synth.npz"


@pytest.fixture(scope="module")
def extractor():
    return init_style_extractor(SYNTH, device="cpu")


@pytest.mark.parametrize("batch", [1, 3])
def test_apply_fn_is_the_module_call(extractor, batch):
    imgs = torch.from_numpy(
        (np.random.RandomState(batch).rand(batch, 96, 128) * 255).astype(np.float32))
    apply_fn = make_apply_fn(extractor)
    got = apply_fn(imgs)
    with torch.no_grad():
        want = extractor(imgs)
    assert got.shape == (batch, STYLE_LEN, 1280) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(apply_fn(imgs), want)  # a second call: the same (no graph on the CPU)
    assert not hasattr(apply_fn, "graphs")


def test_width_bins_are_the_host_formula():
    for w in (1, 2, 13, 14, 15, 27, 128, 385):
        starts = np.floor(np.arange(STYLE_LEN) * w / STYLE_LEN).astype(np.int64)
        ends = np.ceil((np.arange(STYLE_LEN) + 1) * w / STYLE_LEN).astype(np.int64)
        cols = np.arange(w)[:, None]
        ones = ((cols >= starts[None]) & (cols < ends[None])).astype(np.float32)
        assert torch.equal(width_bins(w), torch.from_numpy(ones / ones.sum(0, keepdims=True))), w


def test_jacobi_on_the_drawn_x_init_equals_its_own_draw():
    model = DiffusionModel.from_config({"channels": 16, "att_layers_num": 2}, device="cpu",
                                       seed=5)
    batch, seq_len = 2, 16
    rng = np.random.RandomState(0)
    text = torch.from_numpy(rng.randint(2, 73, (batch, 6)))
    style = torch.from_numpy(rng.randn(batch, 14, 1280).astype(np.float32))

    def denoise_any(x, sigma):
        reps = x.shape[0] // batch
        return model(x, text.repeat(reps, 1), sigma, style.repeat(reps, 1, 1))

    def gen():
        return torch.Generator().manual_seed(42)

    own, own_all = parallel_ddim_sample(denoise_any, batch, seq_len, sweeps=3, generator=gen(),
                                        return_all_sweeps=True, device="cpu")
    x_init = torch.randn((batch, seq_len, 2), generator=gen())
    drawn, drawn_all = parallel_ddim_sample(denoise_any, batch, seq_len, sweeps=3,
                                            x_init=x_init, return_all_sweeps=True, device="cpu")
    assert torch.equal(drawn, own) and torch.equal(drawn_all, own_all)
    assert torch.equal(drawn_all[-1], drawn) and torch.isfinite(drawn).all()
