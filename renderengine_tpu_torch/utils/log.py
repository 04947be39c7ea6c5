"""Engine logger — the custom logger the reference never built
(``todo.md:15``; it uses bare cout, e.g. ``debug_utils.cpp:12``)."""

from __future__ import annotations

import logging
import sys

_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("renderengine_tpu_torch")
        if not _logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s %(name)s] %(message)s",
                                             datefmt="%H:%M:%S"))
            _logger.addHandler(h)
            _logger.setLevel(logging.INFO)
    return _logger


def info(msg, *a):
    get_logger().info(msg, *a)


def warning(msg, *a):
    get_logger().warning(msg, *a)


def error(msg, *a):
    get_logger().error(msg, *a)
