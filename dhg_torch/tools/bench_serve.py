"""HTTP load generator for the serving runtime (port of
dhg/tools/bench_serve.py).

Drives a warmed `python -m dhg_torch.serve` at rising concurrency and
prints lines/s and latency percentiles per level. Each client is a thread
issuing `requests` sequential POST /generate calls (distinct seeds, the
same prompt, so one bucket and the batcher can co-batch across clients up
to the server's --max_batch).

Run:  python -m dhg_torch.tools.bench_serve --url=http://127.0.0.1:8008 \
          [--clients=1,16,32,64,128] [--requests=4] [--prompt=...]
Prints one JSON dict per level, then the server's /healthz stats. A
percentile p is reported only where at least 1 / (1 - p) latencies back it
(p99: 100 requests in the level), else null.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request


def _post(url: str, payload: dict, timeout: float = 600.0):
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def run_level(url: str, clients: int, requests: int, prompt: str, seed0: int) -> dict:
    lat: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()

    def client(ci: int):
        for r in range(requests):
            t0 = time.perf_counter()
            try:
                status, body = _post(
                    url + "/generate",
                    {"prompt": prompt, "seed": seed0 + ci * 1000 + r},
                )
                ok = status == 200
                if not ok:
                    status = f"http {status}: {body.get('error', '')[:80]}"
            except Exception as e:  # noqa: BLE001 - counted as an error
                ok, status = False, repr(e)[:120]
            dt = time.perf_counter() - t0
            with lock:
                if ok:
                    lat.append(dt)
                else:
                    errors.append(str(status))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    n = len(lat)
    return {
        "clients": clients,
        "requests_per_client": requests,
        "ok": n,
        "errors": len(errors),
        "error_samples": sorted(set(errors))[:3],
        "wall_s": round(wall, 2),
        "lines_per_s": round(n / wall, 1),
        **percentiles_ms(lat),
    }


def percentiles_ms(lat: list[float]) -> dict:
    """p50/p90/p99 of latencies in seconds, in ms; each None unless at
    least 1 / (1 - p) samples back it, so that it is not just the largest."""
    lat = sorted(lat)
    n = len(lat)
    out = {}
    for name, p in (("p50_ms", 0.50), ("p90_ms", 0.90), ("p99_ms", 0.99)):
        backed = n >= round(1 / (1 - p))
        out[name] = round(lat[min(int(n * p), n - 1)] * 1000, 1) if backed else None
    return out


def main():
    kv = dict(a.lstrip("-").split("=", 1) for a in sys.argv[1:] if "=" in a)
    url = kv.get("url", "http://127.0.0.1:8008")
    levels = [int(c) for c in kv.get("clients", "1,16,32,64,128").split(",")]
    requests = int(kv.get("requests", 4))
    prompt = kv.get("prompt", "Follow the White Rabbit")

    # One throwaway request first, so level 1 measures steady state.
    _post(url + "/generate", {"prompt": prompt, "seed": 1})

    results = []
    for i, c in enumerate(levels):
        res = run_level(url, c, requests, prompt, seed0=10_000 * (i + 1))
        results.append(res)
        print(json.dumps(res), flush=True)
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    print(json.dumps({"healthz_stats": health.get("stats", {})}))


if __name__ == "__main__":
    main()
