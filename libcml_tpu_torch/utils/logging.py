"""Logging layer: leveled, per-frame-context loggers for the runtimes.

TPU-native replacement for the reference's spdlog wrapper
(reference: src/cml/utils/Logger.h:22-34 — CML_LOG_DEBUG/INFO/WARN/ERROR/
FATAL/IMPORTANT macros; the per-frame prefix pattern reset in
AbstractSlam.cpp:200, where every log line carries the frame id being
processed).

Built on the stdlib logging module: one package logger ("libcml_tpu_torch"),
a frame-context filter injecting the current frame id into every record,
and the reference's IMPORTANT level mapped to a custom level between
WARNING and ERROR.
"""

from __future__ import annotations

import logging
import sys

IMPORTANT = 35  # between WARNING (30) and ERROR (40), Logger.h IMPORTANT
logging.addLevelName(IMPORTANT, "IMPORTANT")

_FRAME: int | None = None


def set_frame(index: int | None) -> None:
    """Set the frame id stamped on subsequent log lines (reference:
    AbstractSlam.cpp:200 resets the spdlog pattern per frame)."""
    global _FRAME
    _FRAME = index


class _FrameFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.frame = "-" if _FRAME is None else str(_FRAME)
        return True


def get_logger(name: str = "libcml_tpu_torch") -> logging.Logger:
    """The package logger, configured once with the frame-context format."""
    log = logging.getLogger(name)
    root = logging.getLogger("libcml_tpu_torch")
    if not getattr(root, "_cml_configured", False):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(levelname)s][f%(frame)s] %(message)s")
        )
        handler.addFilter(_FrameFilter())
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        root._cml_configured = True  # type: ignore[attr-defined]
    return log


def set_level(level: int | str) -> None:
    logging.getLogger("libcml_tpu_torch").setLevel(level)


# CML_LOG_* equivalents (Logger.h:22-34)
_log = get_logger()
debug = _log.debug
info = _log.info
warn = _log.warning
error = _log.error


def important(msg: str, *args) -> None:
    _log.log(IMPORTANT, msg, *args)


def fatal(msg: str, *args) -> None:
    """Log at CRITICAL and raise (the reference's FATAL aborts the run)."""
    _log.critical(msg, *args)
    raise RuntimeError(msg % args if args else msg)
