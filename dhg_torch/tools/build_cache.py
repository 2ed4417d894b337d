"""CLI: build the packed IAM cache of a split for a config (port of
dhg/tools/build_cache.py).

    python -m dhg_torch.tools.build_cache --config=best.yml [--kind=train] \
        [--workers=8] [--device=cpu] [--stats=<file.json>] [--a.b.c=value ...]

Separates the one-time offline cost (stroke XML scanning, line-image reads,
MobileNetV2 style extraction on the card) from training start-up: the
trainer then loads the .npz (dhg's file name and keys, so either package's
cache serves both). Forms are processed on a thread pool (--workers,
default min(8, cpus)); the cache is the same for every worker count. One
JSON line reports the line counts by filter and the seconds by stage;
--stats also writes it to a file.
"""

from __future__ import annotations

import json
import resource
import sys

from dhg_torch.config import DLConfig, fit_config, parse_cli_kwargs
from dhg_torch.data.iam import load_or_build_cache
from dhg_torch.train import iam_cache_kwargs
from dhg_torch.utils.experiment import get_logger


def main(argv=None) -> dict:
    kwargs = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    kind = kwargs.pop("kind", "train")
    workers = kwargs.pop("workers", None)
    device = kwargs.pop("device", "cuda")
    stats_path = kwargs.pop("stats", None)
    cfg = DLConfig(fit_config(**kwargs))
    logger = get_logger("build_cache")

    stats: dict = {"kind": kind}
    build = iam_cache_kwargs(cfg, kind, device)
    build.update(workers=None if workers is None else int(workers), stats=stats)
    cache = load_or_build_cache(**build)
    stats.update(samples=len(cache), style_bytes=int(cache.style.nbytes),
                 peak_host_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    if str(device).startswith("cuda"):
        import torch

        stats["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    logger.info(f"cache ready: {len(cache)} samples ({kind})")
    line = json.dumps(stats)
    print(line, flush=True)
    if stats_path:
        with open(stats_path, "w") as f:
            f.write(line + "\n")
    return stats


if __name__ == "__main__":
    main()
