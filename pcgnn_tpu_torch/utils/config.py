"""Experiment configuration: schema defaults, validation, grid expansion.

Counterpart of ``pcgnn_tpu/utils/config.py`` with the same keys and
defaults.  The trainer also reads two keys of its own for its
one-rank-per-process model, ``dist_backend`` and ``ranks_per_host``
(``train.trainer``), with no default here.  GraphSAGE's
``num_sample`` is read when present; it has no default here, as in the JAX
package.
"""

from __future__ import annotations

import itertools
import json
from typing import List

DEFAULTS = {
    "seed": 72,
    "data_name": "amazon",
    "model": "PCGNN",
    "train_ratio": 0.4,
    "test_ratio": 0.67,
    "emb_size": 64,
    "lr": 0.01,
    "weight_decay": 0.001,
    "alpha": 2.0,
    "rho": 0.5,
    "epochs": 1000,
    "valid_epochs": 10,
    "batch_size": 1024,
    "patience": 100,
    "exp_num": 0,
    "data_prefix": "data/",
    "threshold": 0.5,
    # per-relation choose thresholds; overrides "threshold" when set and is
    # not a sweep axis
    "thresholds": None,
    "graph_id": None,
    "num_devices": 1,
    "mesh_graph": None,
    # edge-window feature stores (PC-GNN: the relations', GCN and GraphSAGE:
    # the homo graph's); false trains on the lanes without stores
    "edge_windows": True,
    # store dtype: "bfloat16" (default) or "float32"
    "ewin_dtype": "bfloat16",
    "distributed": False,
    "coordinator_address": None,
    "num_processes": None,
    "process_id": None,
    "mesh_data": None,
    "learn_features": False,
    # model selection: "gain" (relative AUC + F1-macro gain) or "f1" (the
    # validation threshold sweep, transferred to the test)
    "select": "gain",
}

REQUIRED = ("data_name", "model")


def load_config(path: str) -> dict:
    """JSON, or YAML when the file name ends in .yml/.yaml."""
    with open(path) as f:
        if path.endswith((".yml", ".yaml")):
            import yaml
            cfg = yaml.safe_load(f)
        else:
            cfg = json.load(f)
    return with_defaults(cfg)


def with_defaults(cfg: dict) -> dict:
    out = dict(DEFAULTS)
    out.update(cfg)
    for key in REQUIRED:
        if out.get(key) is None:
            raise ValueError(f"config missing required key {key!r}")
    return out


# list-valued keys that are values, not sweep axes
_NO_GRID = {"thresholds"}


def grid(cfg: dict) -> List[dict]:
    """Expand list-valued entries into the cross product of configs."""
    listed = {k: v for k, v in cfg.items()
              if isinstance(v, list) and k not in _NO_GRID}
    if not listed:
        return [dict(cfg)]
    fixed = {k: v for k, v in cfg.items() if k not in listed}
    keys = list(listed)
    out = []
    for combo in itertools.product(*(listed[k] for k in keys)):
        c = dict(fixed)
        c.update(dict(zip(keys, combo)))
        out.append(c)
    return out


def print_config(config: dict) -> str:
    print("**************** MODEL CONFIGURATION ****************")
    lines = ""
    for key in sorted(config.keys()):
        line = "{}{} -->   {}\n".format(key, " " * (24 - len(key)), config[key])
        lines += line
        print(line, end="")
    print("**************** MODEL CONFIGURATION ****************")
    return lines
