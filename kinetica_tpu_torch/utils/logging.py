"""File logging with date-stamped names, explicit flushing and level filtering.

Same capability as the reference's logging layer
(Julia reference src/logging.jl:15-91): ``start_log``/``end_log`` attach and
detach a file handler on the package logger, ``flush_log`` forces a flush,
and ``with_global_logger`` temporarily routes records to the root logger
(used around progress reporting).
"""
from __future__ import annotations

import contextlib
import logging
import os
import sys
from datetime import datetime

LOGGER_NAME = "kinetica_tpu_torch"
logger = logging.getLogger(LOGGER_NAME)
logger.setLevel(logging.INFO)
if not logger.handlers:
    _sh = logging.StreamHandler(sys.stderr)
    _sh.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    logger.addHandler(_sh)

_file_handlers: list[logging.FileHandler] = []


def start_log(logdir: str, label: str = "Kinetica", min_level: int = logging.INFO) -> str:
    """Open a date-stamped log file ``<logdir>/<label>_YYYY-mm-dd_HHMMSS.log``.

    Returns the log file path. Mirrors reference src/logging.jl:15-26.
    """
    os.makedirs(logdir, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H%M%S")
    path = os.path.join(logdir, f"{label}_{stamp}.log")
    fh = logging.FileHandler(path)
    fh.setLevel(min_level)
    fh.setFormatter(logging.Formatter("[%(asctime)s | %(levelname)s] %(message)s"))
    logger.addHandler(fh)
    _file_handlers.append(fh)
    return path


def end_log(log: str | None = None) -> None:
    """Detach and close a file log started by :func:`start_log`.

    With no argument, closes the most recently started log; passing the
    path returned by ``start_log`` closes that specific log (the
    reference's ``end_log(logger)`` form, logging.jl:29-40).
    """
    if not _file_handlers:
        return
    if log is not None:
        matches = [fh for fh in _file_handlers
                   if getattr(fh, "baseFilename", None) == os.path.abspath(log)]
        if not matches:
            raise ValueError(f"no active file log at {log!r}")
        fh = matches[-1]
        _file_handlers.remove(fh)
    else:
        fh = _file_handlers.pop()
    fh.flush()
    fh.close()
    logger.removeHandler(fh)


def flush_log() -> None:
    """Flush all attached handlers (reference src/logging.jl:50-67)."""
    for handler in logger.handlers:
        try:
            handler.flush()
        except Exception:
            pass


@contextlib.contextmanager
def with_global_logger():
    """Temporarily propagate records to the root logger.

    The reference uses this to let progress bars bypass file loggers
    (src/logging.jl:91). Here it temporarily enables propagation.
    """
    prev = logger.propagate
    logger.propagate = True
    try:
        yield
    finally:
        logger.propagate = prev
