"""Logger mixin for the data modules (counterpart of
``graphnet_tpu/utils/logging.py``): stream logging to stdout, a message
repeated more than ``_MAX_REPEATS`` times suppressed, ``warning_once``."""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "graphnet_tpu_torch"
_MAX_REPEATS = 20


class RepeatFilter(logging.Filter):
    """Let a message through at most ``_MAX_REPEATS`` times, and say so
    when it reaches that count."""

    def __init__(self) -> None:
        super().__init__()
        self._counts: dict = {}

    def filter(self, record: logging.LogRecord) -> bool:
        n = self._counts.get(record.msg, 0) + 1
        self._counts[record.msg] = n
        if n == _MAX_REPEATS:
            logging.getLogger(_LOGGER_NAME).info(
                f"Will not print the below message again "
                f"({_MAX_REPEATS} repeats reached)."
            )
        return n <= _MAX_REPEATS


def get_logger(level: int = logging.INFO) -> logging.Logger:
    """The package's logger, its stdout handler and repeat filter added
    on the first call."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.addFilter(RepeatFilter())
        logger.setLevel(level)
        logger.propagate = False
    return logger


class Logger:
    """Mixin giving a class ``info``, ``warning``, ``warning_once``,
    ``error`` and ``debug``, each message prefixed with the class name."""

    def __init__(self, *args, **kwargs) -> None:
        self._logger = get_logger()
        self._warned: set = set()

    def _ensure(self) -> None:
        if not hasattr(self, "_logger"):
            self._logger = get_logger()
            self._warned = set()

    def info(self, msg: str) -> None:
        self._ensure()
        self._logger.info(f"[{type(self).__name__}] {msg}")

    def warning(self, msg: str) -> None:
        self._ensure()
        self._logger.warning(f"[{type(self).__name__}] {msg}")

    def warning_once(self, msg: str) -> None:
        self._ensure()
        if msg not in self._warned:
            self._warned.add(msg)
            self.warning(msg)

    def error(self, msg: str) -> None:
        self._ensure()
        self._logger.error(f"[{type(self).__name__}] {msg}")

    def debug(self, msg: str) -> None:
        self._ensure()
        self._logger.debug(f"[{type(self).__name__}] {msg}")
