"""Leveled logger shared by the host paths: a thin wrapper over the
stdlib with the reference's level vocabulary, honoring ACCL_LOG_LEVEL."""

from __future__ import annotations

import logging
import os

_LEVELS = {
    "verbose": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _make_logger() -> logging.Logger:
    logger = logging.getLogger("accl_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[ACCL %(levelname)s %(asctime)s] %(message)s",
                              "%H:%M:%S")
        )
        logger.addHandler(h)
    level = os.environ.get("ACCL_LOG_LEVEL", "warning").lower()
    logger.setLevel(_LEVELS.get(level, logging.WARNING))
    return logger


Log = _make_logger()
