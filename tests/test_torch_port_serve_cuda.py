"""The sampler's CUDA graphs and the serving runtime on the card (marker
`cuda`; skipped without one). A small f32 model (C1 = 32, one attention
layer, random weights from seed 0).

Each replay is held to the eager `generate` on the same inputs and draws,
bit for bit. No JAX here, so it runs where the card is (tests/conftest.py
imports jax, hence --noconftest):
    python -m pytest --noconftest -m cuda tests/test_torch_port_serve_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dhg_torch.core.graphs import SamplerGraphs
from dhg_torch.core.sampling import per_sample_noise_streams
from dhg_torch.data.tokenizer import Tokenizer
from dhg_torch.inference import generate
from dhg_torch.models.denoiser import DiffusionModel

SEQ_LEN = 64


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def model(cuda):
    return DiffusionModel.from_config({"channels": 32, "att_layers_num": 1}, device="cuda")


@pytest.fixture(scope="module")
def graphs(model):
    return SamplerGraphs(model, "cuda")


def _request(b, seed, n_steps=60):
    """Device inputs of a batch of b: text [b, 50], style, and the rows'
    noise streams from seeds seed..seed+b-1."""
    rng = np.random.RandomState(seed)
    prompts = ["".join(rng.choice(list("abcdefgh "), rng.randint(1, 3))) for _ in range(b)]
    text = torch.from_numpy(Tokenizer().encode_batch(prompts, 50)).cuda()
    style = torch.from_numpy(rng.randn(b, 14, 1280).astype(np.float32)).cuda()
    x, z = per_sample_noise_streams(range(seed, seed + b), n_steps, SEQ_LEN, "cuda")
    return text, style, x, z


def _eager(model, text, style, x, z, **kw):
    return generate(model, text, style, seq_len=SEQ_LEN, x_init=x, noises=z, device="cuda",
                    **kw).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("guidance", [None, 2.0])
@pytest.mark.parametrize("mode", ["new", "standard", "ddim"])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_cuda_replay_matches_eager(model, graphs, b, mode, guidance):
    text, style, x, z = _request(b, seed=b)
    got = graphs.run(text, style, x, z, SEQ_LEN, mode, guidance)
    want = _eager(model, text, style, x, z, diffusion_mode=mode, guidance_scale=guidance)
    assert got.shape == (b, SEQ_LEN, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_back_to_back_replays_keep_their_own_inputs(model, graphs):
    a, b = _request(4, seed=100), _request(4, seed=200)
    got_a = graphs.run(*a, SEQ_LEN)
    got_b = graphs.run(*b, SEQ_LEN)
    again_a = graphs.run(*a, SEQ_LEN)
    np.testing.assert_array_equal(got_a, again_a)
    np.testing.assert_array_equal(got_b, _eager(model, *b))
    assert not np.array_equal(got_a, got_b)


@pytest.mark.cuda
def test_cuda_one_guided_graph_serves_every_scale(model, graphs):
    text, style, x, z = _request(2, seed=7, n_steps=10)
    before = graphs.captures
    outs = {}
    for g in (1.5, 3.0):
        outs[g] = graphs.run(text, style, x, z, SEQ_LEN, "new", g, n_steps=10)
        np.testing.assert_array_equal(
            outs[g], _eager(model, text, style, x, z, guidance_scale=g, n_steps=10))
    assert graphs.captures == before + 1
    assert SamplerGraphs.key(2, SEQ_LEN, "new", 1.5, 10) in graphs
    assert not np.array_equal(outs[1.5], outs[3.0])


@pytest.mark.cuda
def test_cuda_replay_matches_eager_bf16_model(cuda):
    """Any model: a bf16 one (at this width and batch no sampler kernel
    runs) replays its eager call bit for bit too."""
    model = DiffusionModel.from_config({"channels": 32, "att_layers_num": 1},
                                       dtype=torch.bfloat16, device="cuda")
    text, style, x, z = _request(1, seed=3, n_steps=10)
    got = SamplerGraphs(model, "cuda").run(text, style, x, z, SEQ_LEN, n_steps=10)
    np.testing.assert_array_equal(got, _eager(model, text, style, x, z, n_steps=10))


@pytest.mark.cuda
def test_cuda_service_captures_nothing_after_warmup(model):
    import threading

    from dhg_torch.serve import GenerationService

    bank = torch.randn(2, 14, 1280, generator=torch.Generator().manual_seed(0))
    service = GenerationService(model, bank, max_batch=4, device="cuda")
    try:
        service.warmup([SEQ_LEN], modes=("new",))
        warmed = service.stats_snapshot()["captures"]
        assert warmed == 3  # batch 1, 2 and 4
        results = {}

        def fire(i):
            results[i] = service.generate_line("ab", seed=i, style=[0.3, 0.7] if i % 2 else 1)

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 7 and all(np.isfinite(r[0]).all() for r in results.values())
        stats = service.stats_snapshot()
        assert stats["captures"] == warmed and stats["requests"] == 7
        # The service's batch equals eager generate on the same padded rows.
        got = service._run_bucket([[3, 4, 1]], [5], SEQ_LEN, "new", None)
        text = torch.zeros((1, 50), dtype=torch.long)
        text[0, :3] = torch.tensor([3, 4, 1])
        want = generate(model, text, bank[:1], seq_len=SEQ_LEN, sample_seeds=[5],
                        device="cuda").cpu().numpy()
        np.testing.assert_array_equal(got, want)
        # A variant that was not warmed is captured live, once.
        service.generate_line("ab", seed=1, guidance_scale=2.0)
        service.generate_line("ab", seed=2, guidance_scale=3.0)
        assert service.stats_snapshot()["captures"] == warmed + 1
    finally:
        service.shutdown(timeout=60)
