"""Rank-aware logging (counterpart of hi3d_tpu/utils/logger.py:30-70).

`setup_logger` is `lru_cache`d, so a repeated call returns the same logger
without adding handlers: a console handler on rank 0 (coloured only when
stdout is a TTY) and a `log.txt` file handler on every rank (the file of a
rank past 0 gets a `.rank{r}` suffix). The rank comes from the process group
(`parallel.dist.rank()`, 0 outside one) where the JAX package asks
`jax.process_index()`.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional

from ..parallel import dist as pdist

_COLORS = {
    logging.DEBUG: "\x1b[38;5;245m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"
_FORMAT = "[%(asctime)s %(name)s %(levelname)s] %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color and sys.stdout.isatty() else msg


@functools.lru_cache()
def setup_logger(name: str = "hi3d_tpu", output: Optional[str] = None,
                 distributed_rank: Optional[int] = None) -> logging.Logger:
    """Console (rank 0) + `<output>/log.txt` (every rank) logger; `output`
    ending in ".txt" names the file itself."""
    if distributed_rank is None:
        distributed_rank = pdist.rank()
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(_ColorFormatter(_FORMAT, datefmt=_DATEFMT))
        logger.addHandler(ch)

    if output:
        filename = output if output.endswith(".txt") else os.path.join(output, "log.txt")
        if distributed_rank > 0:
            filename = f"{filename}.rank{distributed_rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
        logger.addHandler(fh)
    return logger
