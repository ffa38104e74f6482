"""Tracing/logging subsystem.

The analog of the reference's ``tracing`` setup
(fantoch/src/util.rs:73-116: subscriber with optional non-blocking log
file; compile-time max level via the ``max_level_debug``/
``max_level_trace`` features, fantoch/Cargo.toml:12-14). Python analog:
one package logger hierarchy under ``fantoch_tpu_torch``, a process-global
init with optional file output, and an environment switch
``FANTOCH_TRACE`` (off|info|debug|trace) standing in for the
compile-time features — call sites guard with ``isEnabledFor`` so the
disabled paths cost one integer compare, the closest Python gets to
compiling the macros out.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

# custom TRACE level below DEBUG (the reference's trace! macro)
TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_root = logging.getLogger("fantoch_tpu_torch")
_initialized = False

_LEVELS = {
    "off": logging.CRITICAL + 10,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": TRACE,
}


def init_tracing(
    level: Optional[str] = None, log_file: Optional[str] = None
) -> logging.Logger:
    """``util::init_tracing_subscriber`` analog. ``level`` defaults to
    ``$FANTOCH_TRACE`` (or off); ``log_file`` appends records to a file
    instead of stderr. Idempotent; returns the package root logger."""
    global _initialized
    explicit = level is not None or log_file is not None
    # the level only changes when passed as an argument (or on first
    # init, from the env); a file-only re-init keeps the prior level
    # instead of downgrading it to $FANTOCH_TRACE/off
    if level is not None:
        _root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    elif not _initialized:
        env = os.environ.get("FANTOCH_TRACE", "off")
        _root.setLevel(_LEVELS.get(env.lower(), logging.INFO))
    if explicit or not _initialized:
        # an explicit re-init replaces the handlers (e.g. switching to a
        # log file after an implicit boot-time init)
        for h in list(_root.handlers):
            _root.removeHandler(h)
            h.close()
        handler: logging.Handler
        if log_file:
            handler = logging.FileHandler(log_file)
        else:
            handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"
            )
        )
        _root.addHandler(handler)
        _root.propagate = False
        _initialized = True
    return _root


def tracer(module: str) -> logging.Logger:
    """Per-module logger, e.g. ``tracer("run.server")``."""
    return _root.getChild(module)


def trace(logger: logging.Logger, msg: str, *args) -> None:
    if logger.isEnabledFor(TRACE):
        logger.log(TRACE, msg, *args)
