"""Config: YAML with base.yml inheritance and dotted CLI overrides (the port's
copy of dhg/config.py).

  * DLConfig — attribute access that reads missing keys as None; builds from
    a plain dict, so a caller needs no YAML at all;
  * fit_config — configs/base.yml, the named config deep-merged over it,
    then dotted overrides (--a.b.c=v);
  * object_from_dict — {type, params} -> (optimizer kind, params) through an
    explicit registry;
  * config_entrypoint — the CLI (--key=value; values parsed as YAML).

PyYAML is imported only where a file or a CLI value is read. Where it is
missing, dump and pretty_text write JSON, which any YAML reader loads.
"""

from __future__ import annotations

import io
import json
import sys
from os import PathLike
from pathlib import Path
from typing import Any

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def _yaml():
    try:
        import yaml
    except ImportError:
        return None
    return yaml


class CfgDict(dict):
    """dict with attribute access; missing keys read as None."""

    def __getattr__(self, key):
        if key.startswith("__"):
            raise AttributeError(key)
        return self.get(key)

    def __setattr__(self, key, value):
        self[key] = value

    def __missing__(self, key):
        return None

    def get(self, key, default=None):
        return _wrap(super().get(key, default))

    def __getitem__(self, key):
        if key not in self:
            return None
        return _wrap(super().__getitem__(key))


def _wrap(v):
    if isinstance(v, dict) and not isinstance(v, CfgDict):
        return CfgDict(v)
    return v


class DLConfig:
    """Config object: attribute access over a plain, dumpable dict."""

    def __init__(self, cfg: dict):
        self._raw = cfg
        self._cfg = CfgDict(cfg)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return self._cfg[item]

    def __getitem__(self, key):
        return self._cfg[key]

    def to_dict(self) -> dict:
        return self._raw

    @classmethod
    def load(cls, path: PathLike | str) -> "DLConfig":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f))

    def dump(self, path: PathLike | str) -> None:
        with open(path, "w") as f:
            f.write(self.pretty_text)

    @property
    def pretty_text(self) -> str:
        yaml = _yaml()
        if yaml is None:
            return json.dumps(self._raw, indent=2) + "\n"
        buf = io.StringIO()
        yaml.safe_dump(self._raw, buf, sort_keys=False)
        return buf.getvalue()


def merge_configs(base_cfg: dict, cfg: dict) -> dict:
    """Deep-merge cfg over base_cfg in place."""
    for k, v in cfg.items():
        if isinstance(v, dict):
            if k not in base_cfg or not isinstance(base_cfg.get(k), dict):
                base_cfg[k] = {}
            merge_configs(base_cfg[k], v)
        else:
            base_cfg[k] = v
    return base_cfg


def update_config(config: dict, params: dict) -> dict:
    """Apply dotted-path overrides {'a.b.c': v}."""
    for k, v in params.items():
        *path, key = k.split(".")
        node = config
        for p in path:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        node[key] = v
    return config


def fit_config(config_dir: PathLike | str | None = None, **kwargs) -> dict:
    """base.yml -> deep-merge the named config -> dotted overrides."""
    import yaml

    cfg_dir = Path(config_dir) if config_dir else CONFIG_DIR
    with open(cfg_dir / "base.yml") as f:
        base = yaml.safe_load(f)
    if "config" in kwargs:
        path = Path(kwargs.pop("config"))
        if not path.exists():
            path = cfg_dir / path
        with open(path) as f:
            base = merge_configs(base, yaml.safe_load(f))
    return update_config(base, kwargs)


# The reference YAML's torch.optim names -> the kinds dhg_torch.train builds.
OPTIMIZER_REGISTRY = {
    "torch.optim.Adam": "adam",
    "torch.optim.AdamW": "adamw",
    "torch.optim.SGD": "sgd",
    "optax.adam": "adam",
    "optax.adamw": "adamw",
    "optax.sgd": "sgd",
}


def object_from_dict(d: dict, **default_kwargs) -> tuple[str, dict]:
    """Resolve a {type, params} dict to (optimizer kind, params)."""
    kwargs = dict(d)
    object_type = kwargs.pop("type", None)
    if object_type is None:
        raise ImportError("Can't initialize any object from dict without `type` key")
    if object_type not in OPTIMIZER_REGISTRY:
        raise ImportError(f"Unknown optimizer type {object_type!r}")
    params = dict(kwargs.pop("params", None) or {})
    for name, value in default_kwargs.items():
        params.setdefault(name, value)
    return OPTIMIZER_REGISTRY[object_type], params


def _parse_value(val: str):
    yaml = _yaml()
    if yaml is not None:
        try:
            return yaml.safe_load(val)
        except yaml.YAMLError:
            return val
    try:
        return json.loads(val)
    except ValueError:
        return val


def parse_cli_kwargs(argv: list[str] | None = None, help_text: str | None = None
                     ) -> dict[str, Any]:
    """Parse --key=value / --key value pairs; --help prints `help_text`."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if help_text is not None and ("--help" in argv or "-h" in argv):
        print(help_text.strip())
        raise SystemExit(0)
    out: dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r} (expected --key=value)")
        arg = arg[2:]
        if "=" in arg:
            key, val = arg.split("=", 1)
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            key, val = arg, argv[i + 1]
            i += 1
        else:
            key, val = arg, "true"
        out[key] = _parse_value(val)
        i += 1
    return out


def config_entrypoint(argv: list[str] | None = None, help_text: str | None = None,
                      kwargs: dict | None = None) -> DLConfig:
    """The run config from CLI arguments (or already parsed `kwargs`)."""
    if kwargs is None:
        kwargs = parse_cli_kwargs(argv, help_text=help_text)
    return DLConfig(fit_config(**kwargs))
