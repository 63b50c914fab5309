"""Experiment logger (reference src/lib/logger.py:17-77): opt.txt with the
command line and config, a timestamped log.txt, and scalars as JSON lines
(scalars.jsonl) where the reference writes TensorBoard events."""
from __future__ import annotations

import json
import os
import sys
import time


class Logger:
    def __init__(self, save_dir: str, config_json: str | None = None):
        os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
        if config_json is not None:
            with open(os.path.join(save_dir, "opt.txt"), "w") as f:
                f.write(f"==> commandline: {' '.join(sys.argv)}\n")
                f.write(config_json)
        log_dir = os.path.join(save_dir,
                               f"logs_{time.strftime('%Y-%m-%d-%H-%M')}")
        os.makedirs(log_dir, exist_ok=True)
        self.log = open(os.path.join(log_dir, "log.txt"), "w")
        self.scalars = open(os.path.join(log_dir, "scalars.jsonl"), "w")
        self._start_line = True

    def write(self, txt: str):
        if self._start_line:
            self.log.write(time.strftime("%Y-%m-%d-%H-%M: "))
        self.log.write(txt)
        self._start_line = txt.endswith("\n")
        self.log.flush()

    def scalar_summary(self, tag: str, value, step: int):
        self.scalars.write(json.dumps({"tag": tag, "value": float(value),
                                       "step": int(step)}) + "\n")
        self.scalars.flush()

    def close(self):
        self.log.close()
        self.scalars.close()
