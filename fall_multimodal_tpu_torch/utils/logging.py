"""Colored console + file logger (capability of reference ``logger.py:8-34``).

The PyTorch port's own copy of the JAX package's ``utils/logging.py``; only
the default logger name differs.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional

_COLORS = {
    logging.DEBUG: "\x1b[38;5;245m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        base = super().format(record)
        return f"{color}{base}{_RESET}" if sys.stderr.isatty() else base


@functools.lru_cache(maxsize=None)
def create_logger(
    output_dir: Optional[str] = None,
    name: str = "fall_multimodal_tpu_torch",
    filename: str = "log.txt",
    level: int = logging.INFO,
) -> logging.Logger:
    logger = logging.getLogger(name)
    # logging.getLogger returns the same named logger process-wide: a second
    # run in one process (tests, notebooks, in-process grids) with a new
    # output_dir would otherwise STACK handlers — duplicated console lines
    # and run B's records appended into run A's log file
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        try:
            handler.close()
        except Exception:
            pass
    logger.setLevel(level)
    logger.propagate = False
    fmt = "[%(asctime)s %(name)s] (%(filename)s:%(lineno)d) %(levelname)s: %(message)s"

    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(_ColorFormatter(fmt))
    logger.addHandler(console)

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, filename), mode="a")
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    return logger
