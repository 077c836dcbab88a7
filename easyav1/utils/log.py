"""Three-level logger (parity: easyav1.c:374-406 — level filter, call-site
prefix, stderr output; default WARNING)."""

from __future__ import annotations

import sys

from easyav1.settings import LogLevel


class Logger:
    def __init__(self, level: LogLevel = LogLevel.WARNING):
        self.level = level

    def _emit(self, tag: str, msg: str) -> None:
        # sys._getframe is a direct C accessor (inspect.currentframe's
        # wrapper plus attribute walks showed up in INFO-level steady
        # state); 2 hops = the caller of error/warning/info
        try:
            frame = sys._getframe(2)
            where = f"{frame.f_code.co_name}:{frame.f_lineno}"
        except ValueError:
            where = "?"
        print(f"[easyav1 {tag} {where}] {msg}", file=sys.stderr)

    def error(self, msg: str) -> None:
        self._emit("ERROR", msg)

    def warning(self, msg: str) -> None:
        if self.level >= LogLevel.WARNING:
            self._emit("WARN", msg)

    def info(self, msg: str) -> None:
        if self.level >= LogLevel.INFO:
            self._emit("INFO", msg)
