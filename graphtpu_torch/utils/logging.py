"""Leveled logging to stderr under the ``graphtpu_torch`` logger
(counterpart of graphtpu/utils/logging.py); GRAPHTPU_LOG_LEVEL sets the
level."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname)-5s [%(name)s] %(message)s"
_ROOT = "graphtpu_torch"


def get_logger(name: str) -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        level = os.environ.get("GRAPHTPU_LOG_LEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level, logging.INFO))
        root.propagate = False
    return logging.getLogger(f"{_ROOT}.{name}")
