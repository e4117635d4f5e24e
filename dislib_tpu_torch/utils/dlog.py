"""``dslib.*`` logging namespace.

Counterpart of ``dislib_tpu/utils/dlog.py``, copied: each estimator logs
fit summaries under ``dslib.<estimator>``, the same logger names as the
reference, and ``verbose=True`` attaches one stderr handler at INFO to its
logger.
"""

from __future__ import annotations

import logging

_ROOT = "dslib"


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}")


def verbose_logger(name: str, verbose: bool) -> logging.Logger:
    """Logger for an estimator fit; verbose=True ensures INFO is emitted."""
    log = get_logger(name)
    if verbose and not getattr(log, "_dslib_handler", False):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(name)s: %(message)s"))
        log.addHandler(h)
        log._dslib_handler = True
    if verbose:
        log.setLevel(logging.INFO)
    return log
