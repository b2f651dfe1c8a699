"""Console and file logging (counterpart of saspa_tpu/utils/logging_utils.py).

`init_logging(logfile=...)` is what the filter stage's aug-JSON builder
calls: it writes `<stem>_<date><suffix>` beside `logfile`.  Given a logdir
`logs/<dataset>/<run_name>` it makes `logs/<dataset>/<date>_<run_name>` with
a `log.log` inside.
"""

from __future__ import annotations

import datetime
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
