"""Console and file logging (counterpart of saspa_tpu/utils/logging_utils.py).

`init_logging(logfile=...)` is what the filter stage's aug-JSON builder
calls: it writes `<stem>_<date><suffix>` beside `logfile`.  Given a logdir
`logs/<dataset>/<run_name>` it makes `logs/<dataset>/<date>_<run_name>` with
a `log.log` inside.  `MetricsWriter` writes the train stage's
metrics.jsonl.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from pathlib import Path

_FMT = "%(asctime)s %(levelname)s %(message)s"


def init_logging(logdir: str | None = None, logfile: str | None = None) -> str:
    """Replaces the root logger's handlers with the console and one file;
    returns the directory of that file."""
    if not (logdir or logfile):
        raise ValueError("logdir or logfile must be provided")
    date_uid = datetime.datetime.now().strftime("%Y_%m%d_%H%M_%S")

    for handler in logging.root.handlers[:]:
        logging.root.removeHandler(handler)

    if logdir:
        p = Path(logdir)
        logdir = str(p.parent / f"{date_uid}_{p.name}")
        os.makedirs(logdir, exist_ok=True)
        log_file = os.path.join(logdir, "log.log")
        ret = logdir
    else:
        parent = Path(logfile).parent
        parent.mkdir(parents=True, exist_ok=True)
        log_file = str(parent / f"{Path(logfile).stem}_{date_uid}{Path(logfile).suffix}")
        ret = str(parent)

    logging.basicConfig(format=_FMT, level=logging.INFO)
    fh = logging.FileHandler(log_file, mode="w")
    fh.setFormatter(logging.Formatter(_FMT))
    logging.getLogger().addHandler(fh)
    logging.info(f"Logging to {log_file}")
    return ret


class MetricsWriter:
    """Appends one JSON line a call to <out_dir>/metrics.jsonl.  The JAX
    package can mirror to wandb, which is not installed where the port runs,
    so `use_wandb` raises."""

    def __init__(self, out_dir: str, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError("--wandb: wandb is not installed where the port runs; metrics go to "
                                      "metrics.jsonl")
        self.path = os.path.join(out_dir, "metrics.jsonl")
        os.makedirs(out_dir, exist_ok=True)

    def log(self, metrics: dict):
        clean = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(clean) + "\n")
