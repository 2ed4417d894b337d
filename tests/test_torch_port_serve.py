"""The port's serving runtime (dhg_torch/serve.py) on the CPU.

(a) Per-request noise streams: a row's draws depend only on its seed, and
generate(sample_seeds=...) is generate(x_init, noises) on those draws.
(b) The slice held to dhg: dhg's own per-request draws
(dhg.core.sampling.per_sample_noise_streams for PRNGKey(seed_i)) handed to
the port's generate as x_init / noises, against dhg's
generate(sample_keys=...) on the same weights and a blended two-entry
style bank; bar: stroke MSE < 1e-3, the sampler's bar
(tests/torch_port_margins.py prints the margin). One group of requests
served by dhg's GenerationService and by the port's, the port drawing
dhg's noise, holds the serving layer's padding, blend and trimming to dhg
under the same bar.
(c) The server's behaviour, mirroring tests/test_serve.py against one
module-scoped server on device="cpu" (the same tiny model: C1 = 32, one
attention layer), max_batch 4.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhg_torch.checkpoint import save_checkpoint
from dhg_torch.core.sampling import per_sample_noise_streams
from dhg_torch.data.tokenizer import Tokenizer
from dhg_torch.inference import generate
from dhg_torch.serve import Draining, GenerationService, serve
from dhg_torch.utils.vis import compose_lines
from dhg_torch.weights import state_dict_from_dhg
from test_torch_port_common import jax_model, port_model, random_params

C1, N_LAYERS = 32, 1
REPO = Path(__file__).resolve().parents[1]
# Two-entry bank: entry 0 (zeros) is the default, entry 1 is selected or blended.
BANK = np.stack([np.zeros((14, 1280)), np.full((14, 1280), 0.1)]).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return random_params(seed=0, c1=C1, num_layers=N_LAYERS)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params, c1=C1, num_layers=N_LAYERS)


@pytest.fixture(scope="module")
def server(model):
    service = GenerationService(model, BANK, max_batch=4, device="cpu")
    # warm_steps / warm_temps allowlist n_steps 30 and temperature 0.5.
    httpd = serve(service, port=0, warmup_buckets=[104], warm_steps=(30,), warm_temps=(0.5,))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    service.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        return json.loads(r.read())


# -- (a) per-request noise streams ----------------------------------------------


@pytest.mark.parametrize("row", [0, 1, 2])
def test_stream_row_depends_only_on_its_seed(row):
    seeds = [5, 123456, 7]
    x, z = per_sample_noise_streams(seeds, 6, 24, "cpu")
    x1, z1 = per_sample_noise_streams([seeds[row]], 6, 24, "cpu")
    assert x.shape == (3, 24, 2) and z.shape == (6, 3, 24, 2)
    assert x.dtype == z.dtype == torch.float32
    assert torch.equal(x[row], x1[0]) and torch.equal(z[:, row], z1[:, 0])
    others = [r for r in range(3) if r != row]
    assert not any(torch.equal(x[row], x[r]) for r in others)


@pytest.mark.parametrize("mode,guidance", [("new", None), ("standard", 2.0), ("ddim", None)])
def test_generate_sample_seeds_is_its_streams(model, mode, guidance):
    text = Tokenizer().encode_batch(["ab", "c"], 8)
    seeds = [3, 11]
    common = dict(seq_len=24, diffusion_mode=mode, guidance_scale=guidance, n_steps=4,
                  temperature=0.7, device="cpu")
    got = generate(model, text, BANK[:1].repeat(2, 0), sample_seeds=seeds, **common)
    x, z = per_sample_noise_streams(seeds, 4, 24, "cpu")
    want = generate(model, text, BANK[:1].repeat(2, 0), x_init=x, noises=z, **common)
    assert torch.equal(got, want)


def test_sample_seeds_excludes_other_randomness(model):
    text = Tokenizer().encode_batch(["ab"], 8)
    style = BANK[:1]
    x, z = per_sample_noise_streams([1], 2, 24, "cpu")
    for extra in (dict(generator=torch.Generator()), dict(x_init=x, noises=z)):
        with pytest.raises(ValueError, match="excludes"):
            generate(model, text, style, seq_len=24, n_steps=2, sample_seeds=[1],
                     device="cpu", **extra)
    with pytest.raises(ValueError, match="sample_seeds for a batch"):
        generate(model, text, style, seq_len=24, n_steps=2, sample_seeds=[1, 2], device="cpu")


# -- (b) the slice held to dhg ---------------------------------------------------

SLICE_PROMPTS = ["ab", "c", "de"]
SLICE_SEEDS = [4, 17, 250]
SLICE_WEIGHTS = np.asarray([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]], np.float32)
SLICE_VARIANTS = {
    "new-60": dict(diffusion_mode="new", n_steps=None, guidance_scale=None, temperature=None),
    "standard-30-guided": dict(diffusion_mode="standard", n_steps=30, guidance_scale=2.0,
                               temperature=0.5),
}


def slice_against_dhg(params, variant):
    """(port strokes, dhg strokes) for SLICE_PROMPTS under one variant: dhg's
    generate(sample_keys=PRNGKey(seed_i)) under one jax.jit, and the port's
    generate on the same weights, the same blended styles and dhg's own
    per-request draws."""
    from dhg.core.sampling import per_sample_noise_streams as dhg_streams
    from dhg.inference import generate as dhg_generate

    kw = SLICE_VARIANTS[variant]
    seq_len, n = 56, kw["n_steps"] or 60
    text = Tokenizer().encode_batch(SLICE_PROMPTS, 50)
    bank = np.random.RandomState(8).randn(2, 14, 1280).astype(np.float32)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SLICE_SEEDS])
    jm = jax_model(c1=C1, num_layers=N_LAYERS)

    @jax.jit
    def run(p, t, w, b, k):
        style = jnp.einsum("bs,shw->bhw", w, b)
        ref = dhg_generate(jm, p, t, style, jax.random.PRNGKey(0), seq_len=seq_len,
                           sample_keys=k, **kw)
        x0, step_keys = dhg_streams(k, n, seq_len)
        noises = jax.vmap(jax.vmap(lambda kk: jax.random.normal(kk, (seq_len, 2))))(step_keys)
        return ref, x0, noises

    ref, x0, noises = jax.block_until_ready(
        run(params, jnp.asarray(text, jnp.int32), SLICE_WEIGHTS, bank, keys))
    model = port_model(params, c1=C1, num_layers=N_LAYERS)
    style = torch.einsum("bs,shw->bhw", torch.from_numpy(SLICE_WEIGHTS), torch.from_numpy(bank))
    ours = generate(model, text, style, seq_len=seq_len, x_init=torch.from_numpy(np.array(x0)),
                    noises=torch.from_numpy(np.array(noises)), device="cpu", **kw)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("variant", list(SLICE_VARIANTS))
def test_slice_matches_dhg_sample_keys(params, variant):
    ours, ref = slice_against_dhg(params, variant)
    assert ours.shape == ref.shape == (3, 56, 3)
    mse = float(np.mean((ours - ref) ** 2))
    assert mse < 1e-3, mse


# One served group, both services: 3 requests in bucket 56 (padded to 4), an
# index, a blend and the default style, trimmed to 40 / 56 / 40 rows.
GROUP_PROMPTS = ["a", "ab", "b"]
GROUP_STYLES = [1, [0.3, 0.7], None]


def served_group_against_dhg(params):
    """(port rows, dhg rows, the seeds the port drew for) for GROUP_PROMPTS
    submitted at once to dhg's GenerationService and to the port's on the
    CPU, both with bucket 56 set and the same weights and bank. The queue
    holds all three before the batcher wakes, so each service runs them as
    one group through _batch_loop, _serve_group and _run_bucket (padding,
    bank blend, trimming). The port's draws are replaced by dhg's threefry
    draws for the same seeds (padding row: seed 0)."""
    from unittest import mock

    from dhg.core.sampling import per_sample_noise_streams as dhg_streams
    from dhg.serve import GenerationService as DhgService

    bank = np.random.RandomState(9).randn(2, 14, 1280).astype(np.float32)

    @jax.jit
    def dhg_draws(keys):
        x0, step_keys = dhg_streams(keys, 60, 56)
        return x0, jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (56, 2))))(step_keys)

    drawn_for = []

    def threefry_streams(seeds, n_steps, seq_len, device):
        assert (n_steps, seq_len) == (60, 56)
        drawn_for.append(list(seeds))
        x0, noises = jax.block_until_ready(
            dhg_draws(jnp.stack([jax.random.PRNGKey(s) for s in seeds])))
        return (torch.from_numpy(np.array(x0)).to(device),
                torch.from_numpy(np.array(noises)).to(device))

    def run(service):
        service.buckets = [56]
        group = [service._make_pending(prompt, seed, None, None, None, None, style)[0]
                 for prompt, seed, style in zip(GROUP_PROMPTS, SLICE_SEEDS, GROUP_STYLES)]
        service._submit(group)
        for p in group:
            assert p.done.wait(timeout=300) and p.error is None, p.error
        stats = service.stats_snapshot()
        service.shutdown(timeout=10)
        assert (stats["batches"], stats["largest_batch"]) == (1, 3), stats
        return [p.result for p in group]

    ref = run(DhgService(jax_model(c1=C1, num_layers=N_LAYERS), params, bank))
    with mock.patch("dhg_torch.inference.per_sample_noise_streams", threefry_streams):
        ours = run(GenerationService(port_model(params, c1=C1, num_layers=N_LAYERS), bank,
                                     device="cpu"))
    return ours, ref, drawn_for


def test_served_group_matches_dhg_service(params):
    ours, ref, drawn_for = served_group_against_dhg(params)
    assert drawn_for == [SLICE_SEEDS + [0]]  # one draw for the group, padded with seed 0
    assert [r.shape for r in ours] == [r.shape for r in ref] == [(40, 3), (56, 3), (40, 3)]
    mse = float(np.mean(np.concatenate([o - r for o, r in zip(ours, ref)]) ** 2))
    assert mse < 1e-3, mse


# -- (c) the server ----------------------------------------------------------------


def test_healthz(server):
    body = _healthz(server)
    assert body["ok"] is True
    assert body["buckets"] == [104]
    assert body["styles"] == 2
    assert body["warm_modes"] == ["new", "standard"]
    assert body["stats"]["captures"] == 0  # no graph on the CPU


def test_style_bank_selection_and_blend(server):
    base = {"prompt": "abc", "seed": 7}
    s0, b_default = _post(server + "/generate", base)
    s1, b_idx0 = _post(server + "/generate", {**base, "style": 0})
    s2, b_idx1 = _post(server + "/generate", {**base, "style": 1})
    s3, b_blend = _post(server + "/generate", {**base, "style": [0.5, 0.5]})
    assert s0 == s1 == s2 == s3 == 200
    assert b_idx0["strokes"] == b_default["strokes"]
    assert b_idx1["strokes"] != b_default["strokes"]
    assert b_blend["strokes"] != b_default["strokes"]
    assert b_blend["strokes"] != b_idx1["strokes"]
    s4, b_w0 = _post(server + "/generate", {**base, "style": [1.0, 0.0]})
    assert s4 == 200
    np.testing.assert_allclose(np.asarray(b_w0["strokes"]), np.asarray(b_default["strokes"]),
                               atol=1e-4)


@pytest.mark.parametrize("bad,msg", [
    (2, "out of range"),
    (-1, "out of range"),
    ([1.0], "one entry per bank style"),
    ([1.0, 2.0, 3.0], "one entry per bank style"),
    (["a", "b"], "numbers"),
    (True, "int index or a list"),
    ("first", "int index or a list"),
])
def test_style_bank_validation_400(server, bad, msg):
    status, body = _post(server + "/generate", {"prompt": "ab", "style": bad})
    assert status == 400
    assert msg in body["error"]


def test_generate_roundtrip(server):
    status, body = _post(server + "/generate", {"prompt": "hello", "seed": 3})
    assert status == 200
    strokes = np.asarray(body["strokes"])
    assert strokes.shape == (104, 3)  # 6 tokens -> 104, the warmed bucket
    assert np.all(np.isfinite(strokes))
    assert body["seq_len"] == 104 and body["ms"] > 0 and body["truncated"] is False


def test_generate_deterministic_by_seed(server):
    s1, b1 = _post(server + "/generate", {"prompt": "abc", "seed": 7})
    s2, b2 = _post(server + "/generate", {"prompt": "abc", "seed": 7})
    assert s1 == s2 == 200
    assert b1["strokes"] == b2["strokes"]


@pytest.mark.parametrize("payload,msg", [({"seed": 1}, "prompt"),
                                         ({"prompt": "x" * 200}, "too long")])
def test_bad_prompt_400(server, payload, msg):
    status, body = _post(server + "/generate", payload)
    assert status == 400
    assert msg in body["error"]


def test_long_prompt_clamps_to_warmed_bucket(server):
    """30 characters -> 31 tokens -> 504 steps, served at the warmed 104."""
    status, body = _post(server + "/generate", {"prompt": "a" * 30, "seed": 2})
    assert status == 200
    assert body["seq_len"] == 104
    assert np.asarray(body["strokes"]).shape == (104, 3)
    assert body["truncated"] is True


def test_warmup_resets_request_stats(server):
    stats = _healthz(server)["stats"]
    for name in ("last_batch_ms", "max_batch_ms", "slow_batches", "captures"):
        assert name in stats, stats
    # Warm-up sent 2 modes x 2 steps x 2 temperatures x batches 1+2+4 = 56
    # requests through the queue; none of them is counted.
    assert stats["requests"] < 30


@pytest.mark.parametrize("payload", [{"diffusion_mode": "standard"}, {"n_steps": 30},
                                     {"temperature": 0.5}, {"guidance_scale": 1.5}])
def test_warmed_variant_served(server, payload):
    status, body = _post(server + "/generate", {"prompt": "abc", "seed": 4, **payload})
    assert status == 200
    strokes = np.asarray(body["strokes"])
    assert strokes.shape == (72, 3) and np.all(np.isfinite(strokes))


def test_guided_requests_differ_by_scale(server):
    s1, b1 = _post(server + "/generate", {"prompt": "abc", "guidance_scale": 1.5, "seed": 5})
    s2, b2 = _post(server + "/generate", {"prompt": "abc", "guidance_scale": 4.0, "seed": 5})
    assert s1 == s2 == 200
    assert b1["strokes"] != b2["strokes"]


def test_healthz_reports_warm_steps_and_temps(server):
    body = _healthz(server)
    assert body["warm_steps"] == [30]
    assert body["warm_temps"] == [0.5, 1.0]


def test_fewer_step_request_differs(server):
    s60, b60 = _post(server + "/generate", {"prompt": "abc", "seed": 21})
    s30, b30 = _post(server + "/generate", {"prompt": "abc", "seed": 21, "n_steps": 30})
    assert s60 == s30 == 200
    assert b30["strokes"] != b60["strokes"]


@pytest.mark.parametrize("field,value", [("n_steps", 60), ("temperature", 1.0)])
def test_default_value_always_allowed_and_identical(server, field, value):
    _, b_default = _post(server + "/generate", {"prompt": "abc", "seed": 22})
    status, body = _post(server + "/generate", {"prompt": "abc", "seed": 22, field: value})
    assert status == 200
    assert body["strokes"] == b_default["strokes"]


def test_temperature_tightens_strokes(server):
    s1, b1 = _post(server + "/generate", {"prompt": "abc", "seed": 31})
    s2, b2 = _post(server + "/generate", {"prompt": "abc", "seed": 31, "temperature": 0.5})
    assert s1 == s2 == 200
    hot, cool = np.asarray(b1["strokes"]), np.asarray(b2["strokes"])
    assert cool[:, :2].std() < hot[:, :2].std()


@pytest.mark.parametrize("payload", [{"diffusion_mode": "ddim"}, {"n_steps": 15},
                                     {"temperature": 2.0}])
def test_unwarmed_variant_rejected_400(server, payload):
    status, body = _post(server + "/generate", {"prompt": "abc", **payload})
    assert status == 400
    assert "not warmed" in body["error"]


def test_wrap_paragraph_request(server):
    status, body = _post(server + "/generate", {"prompt": "ab cd ef", "seed": 11, "wrap": 5})
    assert status == 200 and body["lines"] == 2  # "ab cd" / "ef"
    page = np.asarray(body["strokes"])
    assert page.ndim == 2 and page.shape[1] == 3 and np.all(np.isfinite(page))
    status2, body2 = _post(server + "/generate", {"prompt": "ab cd ef", "seed": 11, "wrap": 5})
    assert status2 == 200 and body2["strokes"] == body["strokes"]
    # Row i samples with seed + i: the page is the composition of the solo lines.
    status3, body3 = _post(server + "/generate", {"prompt": "ab ab", "seed": 11, "wrap": 2})
    assert status3 == 200 and body3["lines"] == 2
    s_a, solo_11 = _post(server + "/generate", {"prompt": "ab", "seed": 11})
    s_b, solo_12 = _post(server + "/generate", {"prompt": "ab", "seed": 12})
    assert s_a == s_b == 200 and solo_11["strokes"] != solo_12["strokes"]
    want = compose_lines([np.asarray(solo_11["strokes"]), np.asarray(solo_12["strokes"])])
    # atol: the JSON round trip of the solo lines (rounded to 5 decimals).
    np.testing.assert_allclose(np.asarray(body3["strokes"]), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("payload,msg", [
    ({"prompt": "hello", "wrap": 50}, "max_text_len"),
    ({"prompt": "a " * 200, "wrap": 1}, "max_page_lines"),
    ({"prompt": "hi", "wrap": 5, "align": "justify"}, "align"),
])
def test_wrap_validation_400(server, payload, msg):
    status, body = _post(server + "/generate", payload)
    assert status == 400 and msg in body["error"]


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_route_404(server, method):
    if method == "POST":
        status, _ = _post(server + "/nope", {})
    else:
        try:
            urllib.request.urlopen(server + "/nope", timeout=30)
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
    assert status == 404


def test_concurrent_requests_are_batched(server):
    before = _healthz(server)["stats"]
    results = {}

    def fire(i):
        results[i] = _post(server + "/generate", {"prompt": f"line {i}", "seed": i})

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(results[i][0] == 200 for i in range(8))
    after = _healthz(server)["stats"]
    assert after["requests"] - before["requests"] == 8
    assert after["batches"] - before["batches"] < 8
    assert after["largest_batch"] >= 2


def test_batch_log_has_each_batch_before_its_results(model):
    """batch_log: one entry per served batch, logged before its requests
    get their rows, with submit <= taken <= start <= end."""
    service = GenerationService(model, BANK[:1], max_batch=4, device="cpu")
    service.buckets = [56]
    seen = []

    def worker(seed):
        service.generate_line("ab", seed=seed)
        seen.append(sum(len(r["submits"]) for r in service.batch_log))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    log = list(service.batch_log)
    service.shutdown(timeout=10)
    assert len(seen) == 6 and min(seen) >= 1
    assert sum(len(r["submits"]) for r in log) == 6
    assert len(log) == service.stats_snapshot()["batches"] < 6
    for r in log:
        assert max(r["submits"]) <= r["start"] and r["taken"] <= r["start"] <= r["end"]
        assert min(r["submits"]) <= r["taken"]


def test_batched_result_identical_to_solo(server):
    """A request draws the same noise alone or co-batched; its strokes
    agree to float32 tolerance (products re-block with the batch size)."""
    status, solo = _post(server + "/generate", {"prompt": "abc", "seed": 11})
    assert status == 200
    results = {}

    def fire(i, prompt, seed):
        results[i] = _post(server + "/generate", {"prompt": prompt, "seed": seed})

    threads = [threading.Thread(target=fire, args=a)
               for a in ((0, "abc", 11), (1, "other words", 5), (2, "zzz", 9))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results[0][0] == 200
    got, want = np.asarray(results[0][1]["strokes"]), np.asarray(solo["strokes"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)


# -- construction, drain and the CLI -----------------------------------------------


def test_entry_points_default_to_cuda(model):
    from dhg_torch.core.graphs import SamplerGraphs

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationService(model, BANK[:1])
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        SamplerGraphs(model, "cpu")


def test_shutdown_drains_inflight_then_refuses(model):
    service = GenerationService(model, BANK[:1], device="cpu")
    results, errors = [], []

    def worker(seed):
        try:
            results.append(service.generate_line("ab", seed=seed)[0])
        except Exception as e:  # pragma: no cover - failure diagnostics
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while service.stats_snapshot()["requests"] < 4 and time.time() < deadline:
        time.sleep(0.01)
    service.shutdown(timeout=600)
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(results) == 4
    assert all(np.all(np.isfinite(r)) for r in results)
    assert not service._batcher.is_alive()
    with pytest.raises(Draining, match="draining"):
        service.generate_line("ab", seed=9)
    service.shutdown()  # idempotent


def test_http_503_when_draining(model):
    service = GenerationService(model, BANK[:1], device="cpu")
    httpd = serve(service, port=0, warmup_buckets=[])
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        service.shutdown(timeout=10)
        status, body = _post(url + "/generate", {"prompt": "ab", "seed": 1})
        assert status == 503 and "draining" in body["error"]
        assert _healthz(url)["ok"] is True
    finally:
        httpd.shutdown()


def test_serve_cli_sigterm_drains_and_exits(tmp_path, params):
    """`python -m dhg_torch.serve --device=cpu` (SIGINT ignored, as in a
    detached process): a request, then SIGTERM; it drains and exits 0."""
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.yml").write_text(json.dumps(
        {"training_args": {"channels": C1, "att_layers_num": N_LAYERS},
         "dataset_args": {"max_text_len": 20, "max_seq_len": 96}}))
    save_checkpoint(exp / "model_final", state_dict_from_dhg(params))
    log = tmp_path / "serve.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "dhg_torch.serve", "--device=cpu",
             f"--experiment_path={exp}", "--port=0", "--warmup_buckets="],
            preexec_fn=lambda: signal.signal(signal.SIGINT, signal.SIG_IGN),
            stdout=out, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"),
        )
    try:
        deadline, port = time.time() + 120, None
        while time.time() < deadline:
            m = re.search(rb"dhg_torch serving on 127\.0\.0\.1:(\d+)", log.read_bytes())
            if m:
                port = int(m.group(1))
                break
            assert proc.poll() is None, log.read_text()
            time.sleep(0.2)
        assert port, "the server never announced its port"
        status, body = _post(f"http://127.0.0.1:{port}/generate", {"prompt": "ab", "seed": 1})
        assert status == 200 and np.asarray(body["strokes"]).shape == (56, 3)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        assert proc.returncode == 0, log.read_text()
        assert b"dhg_torch server stopped (drained)" in log.read_bytes()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_max_batch_scales_batch_size_grid(model):
    svc = GenerationService(model, BANK[:1], max_batch=64, device="cpu")
    assert svc.batch_sizes == (1, 2, 4, 8, 16, 32, 64)
    assert [svc._pad_batch_size(n) for n in (1, 3, 17, 33, 64)] == [1, 4, 32, 64, 64]
    svc.shutdown(timeout=5)
    with pytest.raises(ValueError, match="max_batch"):
        GenerationService(model, BANK[:1], max_batch=24, device="cpu")


def test_bench_serve_run_level(server):
    from dhg_torch.tools.bench_serve import run_level

    res = run_level(server, clients=2, requests=1, prompt="ab", seed0=40)
    assert res["ok"] == 2 and res["errors"] == 0 and res["lines_per_s"] > 0
    assert res["p50_ms"] > 0 and res["p90_ms"] is None and res["p99_ms"] is None


@pytest.mark.parametrize("n,want", [
    (1, (None, None, None)),
    (10, (6.0, 10.0, None)),
    (99, (50.0, 90.0, None)),
    (100, (51.0, 91.0, 100.0)),
    (1000, (501.0, 901.0, 991.0)),
])
def test_bench_serve_percentiles_need_samples(n, want):
    from dhg_torch.tools.bench_serve import percentiles_ms

    lat = [(i + 1) / 1000 for i in reversed(range(n))]  # 1 .. n ms, unsorted
    got = percentiles_ms(lat)
    assert (got["p50_ms"], got["p90_ms"], got["p99_ms"]) == want
