"""Run directories (port of dhg/utils/experiment.py and dhg/utils/log.py).

  * run dir: work_dir/<experiment.name>/<dd.mm>/<HH.MM.SS>;
  * run.log and stdout with the reference's line format
    '%(asctime)s - [%(levelname)s] %(message)s', an "Environment info:"
    banner and a "Set random seed to ..." line;
  * at the end, the resolved config.yml and report.json
    {run_name, exp_dir, sha, host_name, seed, exp_name}.
"""

from __future__ import annotations

import json
import logging
import os
import platform
import random
import subprocess
import sys
from datetime import datetime
from getpass import getuser
from pathlib import Path
from socket import gethostname

import numpy as np
import torch

FORMAT = "%(asctime)s - [%(levelname)s] %(message)s"


def get_logger(name: str, log_dir: Path | str | None = None) -> logging.Logger:
    """A logger writing to stdout and, with log_dir, to <log_dir>/run.log.
    Each call replaces the handlers of an earlier one of the same name, so
    a second run in one process logs into its own directory."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    formatter = logging.Formatter(FORMAT)
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_dir is not None:
        handlers.append(logging.FileHandler(Path(log_dir) / "run.log", mode="w"))
    for h in handlers:
        h.setFormatter(formatter)
        logger.addHandler(h)
    return logger


def collect_env(device: torch.device) -> dict:
    info = {
        "sys.platform": sys.platform,
        "Python": sys.version.replace("\n", ""),
        "Platform": platform.platform(),
        "PyTorch": torch.__version__,
        "CUDA": str(torch.version.cuda),
        "device": str(device),
    }
    if device.type == "cuda":
        info["GPU"] = torch.cuda.get_device_name(device)
    return info


def git_sha() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                              timeout=5, cwd=Path(__file__).parent).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def set_random_seed(seed: int, precision: int = 10) -> None:
    random.seed(seed)
    np.random.seed(seed)
    np.set_printoptions(precision=precision)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)


class ExperimentDir:
    """A training run's directory, logger and report metadata."""

    def __init__(self, cfg, device: torch.device, logger_name: str = "dhg_torch.train"):
        self.cfg = cfg
        run_name = f"{cfg.experiment.name}/{datetime.now().strftime('%d.%m/%H.%M.%S')}"
        self.path = Path(cfg.experiment.work_dir) / run_name
        self.path.mkdir(parents=True, exist_ok=True)
        self.logger = get_logger(logger_name, self.path)
        self.meta = {
            "run_name": run_name,
            "exp_dir": str(self.path),
            "sha": git_sha(),
            "host_name": f"{getuser()}@{gethostname()}",
            "seed": cfg.experiment.seed,
            "exp_name": cfg.experiment.name,
        }
        env = "\n".join(f"{k}: {v}" for k, v in collect_env(device).items())
        dash = "-" * 60 + "\n"
        self.logger.info("Environment info:\n" + dash + env + "\n" + dash)
        seed = cfg.experiment.seed
        if seed is not None:
            self.logger.info(f"Set random seed to {seed}, deterministic: False \n")
            set_random_seed(seed, precision=cfg.experiment.precision or 10)

    def write_artifacts(self) -> None:
        """The resolved config.yml and report.json."""
        self.cfg.dump(self.path / "config.yml")
        with open(self.path / "report.json", "w") as f:
            json.dump(self.meta, f, indent=4)
