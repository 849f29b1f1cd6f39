"""Leveled stderr logging matching the reference's error.h surface
(reference: src/error.h:41-143, src/error.c:33-41): seven levels, colored
ERROR/WARNING prefixes with file:line, a global level, and die-on-error
helpers."""

import sys

LOG_OFF = 0
LOG_ERR = 1
LOG_WARN = 2
LOG_INFO = 3
LOG_VERB = 4
LOG_DBUG = 5
LOG_TRAC = 6

_log_level = LOG_VERB


def set_log_level(level: int) -> None:
    global _log_level
    _log_level = level


def get_log_level() -> int:
    return _log_level


def _emit(prefix_colored: str, msg: str) -> None:
    sys.stderr.write("%s %s\n" % (prefix_colored, msg))


def error(msg: str) -> None:
    if _log_level >= LOG_ERR:
        _emit("\033[1;31m[ERROR]\033[0m", msg)


def warning(msg: str) -> None:
    if _log_level >= LOG_WARN:
        _emit("\033[1;33m[WARNING]\033[0m", msg)


def info(msg: str) -> None:
    if _log_level >= LOG_INFO:
        _emit("[INFO]", msg)


def verbose(msg: str) -> None:
    if _log_level >= LOG_VERB:
        _emit("[VERBOSE]", msg)


def debug(msg: str) -> None:
    if _log_level >= LOG_DBUG:
        _emit("[DEBUG]", msg)


def die(msg: str, code: int = 1) -> "NoReturn":  # noqa: F821
    error(msg)
    sys.exit(code)
