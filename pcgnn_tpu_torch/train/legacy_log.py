"""Legacy plain-text run logger.

Counterpart of ``pcgnn_tpu/train/legacy_log.py``, for users of the
reference's older ``log`` class: four append-only text streams (train /
valid / test / multiple-run) under ``log(<data>, <model>)/``, one file per
run keyed by a start-time suffix.  New code should prefer
``pcgnn_tpu_torch.train.results.ResultManager``.
"""

from __future__ import annotations

import os
from datetime import datetime

_STREAMS = ("train", "valid", "test", "multiple-run")


class LegacyLog:
    def __init__(self, model_name: str = None, data_name: str = None,
                 root: str = "."):
        self.time_step = str(datetime.now())
        self.log_dir_path = os.path.join(root,
                                         f"log({data_name}, {model_name})")
        self.log_file_name = (f"({model_name})"
                              + self.time_step.split(":")[-1] + ".log")
        self._paths = {}
        for stream in _STREAMS:
            d = os.path.join(self.log_dir_path, stream)
            os.makedirs(d, exist_ok=True)
            self._paths[stream] = os.path.join(d, self.log_file_name)

    def _write(self, stream: str, line: str, print_line: bool):
        if print_line:
            print(line)
        with open(self._paths[stream], "a") as f:
            f.write(line + "\n")

    def write_train_log(self, line: str, print_line: bool = True):
        self._write("train", line, print_line)

    def write_valid_log(self, line: str, print_line: bool = True):
        self._write("valid", line, print_line)

    def write_test_log(self, line: str, print_line: bool = True):
        self._write("test", line, print_line)

    def multi_run_log(self, line: str, print_line: bool = True):
        self._write("multiple-run", line, print_line)
