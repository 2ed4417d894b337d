"""The port's multi-process training and sampling (dhg_torch/parallel) on the
CPU: the tensor-parallel rule against dhg's `_spec_for`, sharding round
trips, the mesh's rank layout, and one spawn of two gloo processes that
covers data parallelism, tensor parallelism, the DHG_COORDINATOR start-up,
artifact ownership and the sampler over the data axis, each held against
the one-process run.

Dropout stays live in the spawned runs: every rank draws each mask for the
whole batch from a generator seeded per step (ops/basic.py dropout_rows),
so the ranks drop what the one-process run drops.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dhg_torch.config import DLConfig
from dhg_torch.inference import generate
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.parallel.mesh import make_mesh, mesh_layout
from dhg_torch.parallel.sharding import shard_dim, shard_state_dict
from dhg_torch.train import Trainer
from test_torch_port_common import random_params

ROOT = Path(__file__).resolve().parents[1]
C1, LAYERS, B, T_LEN, L_LEN, STEPS = 16, 1, 4, 16, 14, 3
CFG = {
    "experiment": {"seed": 0, "name": "par"},
    "dataset_args": {"max_seq_len": T_LEN, "max_text_len": L_LEN},
    "training_args": {"channels": C1, "att_layers_num": LAYERS, "batch_size": B, "max_files": 8,
                      "warmup_steps": 20, "clip_grad": 100.0, "clip_mode": "norm",
                      "compute_dtype": "float32", "dataset": "synthetic", "steps": 2,
                      "log_freq": 1, "save_freq": 2},
    "optimizer": {"type": "torch.optim.Adam",
                  "params": {"betas": [0.9, 0.98], "weight_decay": 1e-5}},
}
GEN_MODEL = {"channels": C1, "att_layers_num": LAYERS}
GEN_TEXT = [[5, 6, 7, 1, 0], [8, 9, 1, 0, 0], [10, 11, 12, 13, 1]]

WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
rank, port, out, cfg = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
steps, gen_model, gen_text = int(sys.argv[5]), json.loads(sys.argv[6]), json.loads(sys.argv[7])
os.environ.update(DHG_COORDINATOR=f"localhost:{port}", DHG_NUM_PROCESSES="2",
                  DHG_PROCESS_ID=str(rank))
from dhg_torch.config import DLConfig
from dhg_torch.inference import generate
from dhg_torch.models.denoiser import DiffusionModel
from dhg_torch.parallel import distributed as dist
from dhg_torch.parallel.mesh import make_mesh
from dhg_torch.parallel.sharding import gather_state_dict, shard_state_dict
from dhg_torch.train import Trainer, main

res = {"joined": dist.initialize_from_config(None, "cpu"), "is_main": dist.is_main(),
       "count": dist.process_count()}
for name, mp in (("dp", 1), ("tp", 2)):
    mesh = make_mesh(model_parallel=mp)
    res[name + "_shape"] = list(mesh.shape)
    tr = Trainer(DLConfig(cfg), "cpu", mesh=mesh)
    res[name] = [tr.train_step(tr.draw(c)).tolist() for c in range(1, steps + 1)]
    if name == "tp":
        state = tr.checkpoint_state()["state_dict"]
        full = DiffusionModel.from_config(gen_model, device="cpu", seed=0).state_dict()
        back = gather_state_dict(shard_state_dict(full, mesh.model_index, 2), mesh.model_group)
        res["roundtrip"] = all(torch.equal(back[k], full[k]) for k in full)
        res["local_shapes"] = {k: list(v.shape) for k, v in tr.model.state_dict().items()
                               if k.startswith("enc3.mha.") or k.startswith("enc3.ffn.")}
        if rank == 0:
            torch.save(state, os.path.join(out, "tp_state.pt"))
model = DiffusionModel.from_config(gen_model, device="cpu", seed=5)
style = torch.randn((len(gen_text), 14, 1280), generator=torch.Generator().manual_seed(2))
res["generate"] = generate(model, gen_text, style, torch.Generator().manual_seed(3), seq_len=16,
                           n_steps=4, device="cpu", mesh=make_mesh()).tolist()
trainer = main(DLConfig(cfg), device="cpu")
res["exp_dir"] = None if trainer.exp_dir is None else str(trainer.exp_dir)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Two gloo processes over one DHG_COORDINATOR group; each rank's JSON."""
    tmp = tmp_path_factory.mktemp("gloo")
    (tmp / "worker.py").write_text(WORKER)
    cfg = json.loads(json.dumps(CFG))
    cfg["experiment"]["work_dir"] = str(tmp / "runs")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("DHG_COORDINATOR", None)
    port = _free_port()
    args = [json.dumps(cfg), str(STEPS), json.dumps(GEN_MODEL), json.dumps(GEN_TEXT)]
    procs = [subprocess.Popen([sys.executable, str(tmp / "worker.py"), str(r), str(port),
                               str(tmp), *args], env=env, cwd=str(tmp),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
    return tmp, [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def one_process():
    """The one-process Trainer's STEPS loss triples from the same config."""
    tr = Trainer(DLConfig(CFG), "cpu")
    assert tr.mesh.shape == (1, 1) and tr.mesh.data_group is None
    return [tr.train_step(tr.draw(c)).tolist() for c in range(1, STEPS + 1)]


# -- no process group ----------------------------------------------------------


def _port_name_of_each_dhg_leaf(params):
    """{dhg path tuple: port state_dict name}: every dhg leaf filled with its
    own id, carried through weights.py, found again by value."""
    import flax

    from dhg_torch.weights import state_dict_from_dhg

    flat = flax.traverse_util.flatten_dict(params)
    marked = {k: np.full(np.shape(v), i, np.float32) for i, (k, v) in enumerate(flat.items())}
    sd = state_dict_from_dhg(flax.traverse_util.unflatten_dict(marked))
    by_id = {}
    for name, t in sd.items():
        ids = torch.unique(t)
        assert ids.numel() == 1, name
        by_id[int(ids)] = name
    return {k: by_id[i] for i, k in enumerate(flat)}, flat


def test_sharding_rule_marks_what_dhg_marks():
    from jax.sharding import PartitionSpec as P

    from dhg.parallel.sharding import _spec_for

    params = random_params(seed=2, c1=C1, num_layers=2)
    names, flat = _port_name_of_each_dhg_leaf(params)
    assert len(names) == len(set(names.values()))
    want = {P(): None, P(None, "model"): 0, P("model"): 0, P("model", None): 1}
    marked = 0
    for path, name in names.items():
        dim = want[_spec_for(path, np.shape(flat[path]))]
        assert shard_dim(name) == dim, (path, name)
        marked += dim is not None
    # 7 FFNs x 3 tensors (fc1 weight and bias, fc2 weight); 9 attentions x 7
    # (wq, wk, wv weights and biases, dense weight).
    assert marked == 7 * 3 + 9 * 7


@pytest.mark.parametrize("size", [2, 4])
def test_shards_concatenate_back_exactly(size):
    sd = DiffusionModel.from_config({"channels": C1, "att_layers_num": 2}, device="cpu",
                                    seed=1).state_dict()
    shards = [shard_state_dict(sd, i, size) for i in range(size)]
    for name, full in sd.items():
        dim = shard_dim(name)
        if dim is None:
            assert all(s[name] is full for s in shards)
            continue
        assert all(s[name].shape[dim] * size == full.shape[dim] for s in shards)
        assert torch.equal(torch.cat([s[name] for s in shards], dim), full), name


@pytest.mark.parametrize("world,mp,data,model", [
    (4, 1, [[0], [1], [2], [3]], [[0, 1, 2, 3]]),
    (4, 2, [[0, 1], [2, 3]], [[0, 2], [1, 3]]),
    (8, 1, [[i] for i in range(8)], [list(range(8))]),
    (8, 2, [[0, 1], [2, 3], [4, 5], [6, 7]], [[0, 2, 4, 6], [1, 3, 5, 7]]),
])
def test_mesh_layout(world, mp, data, model):
    """Rows are model groups (one per data index), columns data groups (one
    per model index), as dhg reshapes its devices to (data, model)."""
    grid = mesh_layout(world, mp)
    assert grid.shape == (world // mp, mp)
    assert grid.tolist() == data
    assert grid.T.tolist() == model


def test_one_process_mesh_adds_nothing():
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="needs as many processes"):
        make_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_layout(4, 2, data_parallel=3)


# -- two gloo processes ----------------------------------------------------------


def test_coordinator_environment_forms_the_group(spawned):
    _, ranks = spawned
    assert [r["joined"] for r in ranks] == [True, True]
    assert [r["is_main"] for r in ranks] == [True, False]
    assert [r["count"] for r in ranks] == [2, 2]
    assert [r["dp_shape"] for r in ranks] == [[2, 1]] * 2
    assert [r["tp_shape"] for r in ranks] == [[1, 2]] * 2


def test_data_parallel_matches_one_process(spawned, one_process):
    _, ranks = spawned
    for r in ranks:
        np.testing.assert_allclose(r["dp"], one_process, rtol=1e-5)
    assert len({round(row[0], 6) for row in one_process}) == STEPS  # the steps moved


def test_tensor_parallel_matches_one_process(spawned, one_process):
    _, ranks = spawned
    for r in ranks:
        np.testing.assert_allclose(r["tp"], one_process, rtol=1e-5)
    # enc3's 3 heads of 8 split 12 / 12 columns (a gathered attention), its FFN hidden 48 -> 24.
    assert ranks[1]["local_shapes"]["enc3.mha.wq.weight"] == [12, 24]
    assert ranks[1]["local_shapes"]["enc3.mha.dense.weight"] == [24, 12]
    assert ranks[1]["local_shapes"]["enc3.ffn.1.weight"] == [24, 24]
    assert ranks[1]["local_shapes"]["enc3.ffn.3.weight"] == [24, 24]


def test_tensor_parallel_checkpoint_loads_into_one_device(spawned):
    from test_torch_port_common import inputs, t

    tmp, ranks = spawned
    assert all(r["roundtrip"] for r in ranks)
    state = torch.load(tmp / "tp_state.pt", weights_only=True)
    model = DiffusionModel.from_config(GEN_MODEL, device="cpu")
    model.load_state_dict(state, strict=True)
    # The gathered model computes what the one-process run's model computes
    # after the same steps. (Weights are not compared one by one: Adam
    # divides each gradient by its own size, so a gradient that is rounding
    # noise, as a key bias's under softmax, moves by ~lr either way.)
    tr = Trainer(DLConfig(CFG), "cpu")
    for c in range(1, STEPS + 1):
        tr.train_step(tr.draw(c))
    x, text, sigma, style = (t(a) for a in inputs(batch=2, seq_len=T_LEN, text_len=6, seed=3))
    with torch.no_grad():
        got = model.eval()(x, text, sigma, style)
        want = tr.model.eval()(x, text, sigma, style)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_only_rank_zero_writes_a_run_dir(spawned):
    tmp, ranks = spawned
    assert ranks[1]["exp_dir"] is None
    run = Path(ranks[0]["exp_dir"])
    assert run.parent.parent.parent == tmp / "runs"
    assert [p.parent for p in (tmp / "runs").rglob("run.log")] == [run]
    assert (run / "model_final").is_file() and (run / "metrics.jsonl").is_file()
    assert "2 processes, mesh (data, model) (2, 1)" in (run / "run.log").read_text()
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 3]
    DiffusionModel.load(run / "model_final", device="cpu")


def test_generate_over_the_data_axis_matches_one_process(spawned):
    _, ranks = spawned
    model = DiffusionModel.from_config(GEN_MODEL, device="cpu", seed=5)
    style = torch.randn((len(GEN_TEXT), 14, 1280), generator=torch.Generator().manual_seed(2))
    want = generate(model, GEN_TEXT, style, torch.Generator().manual_seed(3), seq_len=16,
                    n_steps=4, device="cpu").numpy()
    for r in ranks:
        got = np.asarray(r["generate"], np.float32)
        assert got.shape == want.shape == (3, 16, 3)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
