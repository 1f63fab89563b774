"""
Experiment log of the port (counterpart of ``textocvp_tpu/core/logger.py``):
a tee logger that appends timestamped lines to ``<exp>/logs.txt``, and the
method-call tracing decorators ``log_function`` / ``for_all_methods``.

The last :class:`Logger` made is the process's: :func:`print_` writes to
stdout and to its ``logs.txt``. An exception is logged to ``logs.txt`` and
raised again.
"""

from __future__ import annotations

import datetime
import functools
import os
import sys
import traceback
from pathlib import Path

_LOGGER: "Logger | None" = None


class Logger:
    """Tee logger writing timestamped messages to ``<exp_path>/logs.txt``.

    ``file_writes_enabled`` False (ranks other than 0 of a process group,
    ``parallel/distributed.py``) keeps ``logs.txt`` to one writer: the
    messages still reach stdout."""

    file_writes_enabled = True

    def __init__(self, exp_path: str | os.PathLike):
        self.exp_path = Path(exp_path)
        self.file = self.exp_path / "logs.txt"
        self.exp_path.mkdir(parents=True, exist_ok=True)
        global _LOGGER
        _LOGGER = self

    def log(self, message: str, typ: str = "info") -> None:
        if not Logger.file_writes_enabled:
            return
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(self.file, "a") as f:
            f.write(f"{ts}    {typ.upper()}: {message}\n")

    def log_exception(self, e: BaseException) -> None:
        self.log("".join(traceback.format_exception(type(e), e, e.__traceback__)), "error")


def print_(message: str, typ: str = "info") -> None:
    """Print to stdout and, when a Logger is active, to its ``logs.txt``."""
    print(message)
    if _LOGGER is not None:
        _LOGGER.log(message, typ)
    sys.stdout.flush()


def log_info(message: str) -> None:
    """Write to the active Logger's ``logs.txt`` only."""
    if _LOGGER is not None:
        _LOGGER.log(message, "info")


def log_exception(e: BaseException) -> None:
    """An exception's traceback into the active Logger's ``logs.txt``."""
    if _LOGGER is not None:
        _LOGGER.log_exception(e)


def log_function(func):
    """Logs ``Calling: <name>...`` when a public method starts (private
    helpers may run every iteration) and any exception before raising it."""

    @functools.wraps(func)
    def traced(*args, **kwargs):
        if _LOGGER is not None and not func.__name__.startswith("_"):
            _LOGGER.log(f"Calling: {func.__name__}...")
        try:
            return func(*args, **kwargs)
        except Exception as e:
            log_exception(e)
            raise

    return traced


def for_all_methods(decorator):
    """Class decorator: ``decorator`` on every method the class defines, its
    static and class methods kept as such."""

    def decorate(cls):
        for attr, val in list(cls.__dict__.items()):
            if attr.startswith("__"):
                continue
            if isinstance(val, staticmethod):
                setattr(cls, attr, staticmethod(decorator(val.__func__)))
            elif isinstance(val, classmethod):
                setattr(cls, attr, classmethod(decorator(val.__func__)))
            elif callable(val):
                setattr(cls, attr, decorator(val))
        return cls

    return decorate
