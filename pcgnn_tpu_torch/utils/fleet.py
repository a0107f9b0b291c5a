"""Sweep runner: every config of a directory trained as a subprocess of
``python -m pcgnn_tpu_torch.cli`` (on the GPU, the CLI's default), at most
``jobs`` at a time.  Results land in the shared ``experimental_results``
tree, which ``train.analysis`` aggregates.

Counterpart of ``pcgnn_tpu/utils/fleet.py``.

Usage:
  python -m pcgnn_tpu_torch.utils.fleet --config_dir experiment_configs [--jobs 1]
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time


def run_configs(config_dir: str, jobs: int = 1, python: str = sys.executable,
                dry_run: bool = False) -> int:
    """Launch one CLI run per ``*.json`` in ``config_dir`` (sorted), at most
    ``jobs`` at once; returns the number that failed.  ``dry_run`` prints
    the commands and launches nothing."""
    paths = sorted(glob.glob(os.path.join(config_dir, "*.json")))
    if not paths:
        print(f"no configs found in {config_dir}")
        return 0
    print(f"{len(paths)} configs, {jobs} concurrent job(s)")
    active: list = []
    failures = 0
    for path in paths:
        while len(active) >= jobs:
            for p in list(active):
                if p.poll() is not None:
                    active.remove(p)
                    failures += p.returncode != 0
            time.sleep(0.5)
        cmd = [python, "-m", "pcgnn_tpu_torch.cli",
               f"--exp_config_path={path}"]
        print("launch:", " ".join(cmd))
        if dry_run:
            continue
        active.append(subprocess.Popen(cmd))
    for p in active:
        p.wait()
        failures += p.returncode != 0
    print(f"done; {failures} failed")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_dir", default="experiment_configs")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)
    sys.exit(1 if run_configs(args.config_dir, args.jobs,
                              dry_run=args.dry_run) else 0)


if __name__ == "__main__":
    main()
