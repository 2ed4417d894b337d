"""dhg's last jitted programs replayed on the card (marker `cuda`; skipped
without one), each against its eager run, bit for bit: the StyleExtractor's
apply_fn (one graph a shape, B = 1 and 32: the first call eager, the second
captured, later ones replayed; an in-place weight update read, a replaced
storage captured again); the style trunk's step (TrunkStep) against the
eager body over the same draws (losses, accuracies, weights and Adam
moments); one profile_stages loop (the whole denoise step at batch 8,
through the bottleneck and encoder-layer kernels, launches equal); and
eval_parallel_sampler's Jacobi graphs, each sweep count's replay against
the eager run's sweep. No JAX here, so it runs where the card is:
    python -m pytest --noconftest -m cuda tests/test_torch_port_jitted_programs_cuda.py -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch.core.graphs import CapturedBody
from dhg_torch.kernels.runtime import launch_counts
from dhg_torch.models.style_extractor import init_style_extractor, make_apply_fn
from dhg_torch.tools import eval_parallel_sampler, profile_stages
from dhg_torch.tools import train_style_trunk as tst

SYNTH = Path(__file__).resolve().parents[1] / "data" / "style_trunk_synth.npz"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _delta(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


def _imgs(batch, seed, device, width=128):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(batch, 96, width) * 255).astype(np.float32)).to(device)


@pytest.mark.cuda
def test_apply_fn_replays_equal_the_module_call(cuda):
    extractor = init_style_extractor(SYNTH, device=cuda)
    apply_fn = make_apply_fn(extractor)
    for batch in (1, 32):
        for call in range(4):
            x = _imgs(batch, 10 * batch + call, cuda)
            got = apply_fn(x)
            with torch.inference_mode():
                want = extractor(x)
            assert torch.equal(got, want), (batch, call)
            assert (batch, call) != (1, 0) or apply_fn.graphs.captures == 0  # eager first
    graphs = apply_fn.graphs
    assert graphs.captures == len(graphs.graphs) == 2 and len(graphs.seen) == 2
    x = _imgs(32, 7, cuda)
    with torch.no_grad():
        extractor.mobilenet.head.bn.weight.mul_(1.5)  # in place: the next replay reads it
    with torch.inference_mode():
        want = extractor(x)
    assert torch.equal(apply_fn(x), want) and graphs.captures == 2
    with torch.no_grad():
        extractor.mobilenet.head.conv.weight.data = extractor.mobilenet.head.conv.weight.clone()
    assert torch.equal(apply_fn(x), want) and graphs.captures == 3  # a new storage


@pytest.mark.cuda
def test_trunk_steps_replayed_equal_eager_steps(cuda):
    imgs, labels = tst.build_training_set(4, 4, 128)
    imgs_dev = torch.from_numpy(imgs).to(cuda)
    labels_dev = torch.from_numpy(labels.astype(np.int64)).to(cuda)
    steps = []
    for _ in range(2):
        net = tst.make_classifier(4, 0, cuda)
        steps.append(tst.TrunkStep(net, tst.make_optimizer(net, 0.05, 60), imgs_dev, labels_dev))
    eager, graph = steps
    gen = torch.Generator(cuda).manual_seed(3)
    rows = {"eager": [], "graph": []}
    for _ in range(8):
        idx = torch.randint(0, len(imgs), (8,), generator=gen, device=cuda)
        eager.opt.stage()
        rows["eager"].append(eager.body(idx))
        rows["graph"].append(graph(idx).clone())
    assert graph.graph is not None and graph.graph.capture_s > 0
    assert torch.equal(torch.stack(rows["eager"]), torch.stack(rows["graph"]))
    for a, b in zip(eager.opt.params + eager.opt.mu + eager.opt.nu,
                    graph.opt.params + graph.opt.mu + graph.opt.nu):
        assert torch.equal(a, b)
    assert not torch.equal(eager.opt.params[0], tst.make_classifier(4, 0, cuda).extractor
                           .mobilenet.stem.conv.weight)  # the steps moved the trunk


@pytest.mark.cuda
def test_profile_stages_replay_equals_the_eager_loop(cuda, monkeypatch):
    monkeypatch.setattr(profile_stages, "N_STEPS", 3)
    model, stages = profile_stages.build_stages(8, 1, cuda)
    body, x0 = stages["full"]
    with torch.inference_mode():
        loop = profile_stages.stage_loop(body)
        before = launch_counts()
        want = loop(x0)
        eager_launches = _delta(before)
        graph = CapturedBody(loop, (x0,), (model,), cuda)
        graph.run()
        before = launch_counts()
        got = graph.run()
        replay_launches = _delta(before)
    assert torch.equal(got, want)
    assert replay_launches == eager_launches == {"fused_bottleneck": 3, "fused_encoder_layer": 6}


@pytest.mark.cuda
def test_jacobi_replays_equal_the_eager_sweeps(cuda, capsys):
    report = eval_parallel_sampler.main(["--device=cuda", "--tokens=1", "--sweeps=2,3",
                                         "--iters=2"])
    assert report["replay_equals_eager"] == {2: True, 3: True}
    assert all(r["ms_per_call"] > 0 and np.isfinite(r["stroke_mse"]) for r in report["rows"])
    assert "replays equal to the eager run's sweeps" in capsys.readouterr().out
