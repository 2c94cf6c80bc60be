"""Logging setup with the custom REPORT level.

The port's copy of ``blues_tpu.reporters.logger`` (the default logger is
``blues_tpu_torch``). Equivalent of the reference's
addLoggingLevel/init_logger/LoggerFormatter (blues/reporters.py:27-126,
blues/formats.py:21-84): reporter rows stream
through the logging stack at a dedicated REPORT level (WARNING - 5) so they
are always visible without being warnings.
"""

from __future__ import annotations

import logging
import sys

REPORT_LEVEL = logging.WARNING - 5


def add_report_level():
    if hasattr(logging, "REPORT"):
        return
    logging.addLevelName(REPORT_LEVEL, "REPORT")
    logging.REPORT = REPORT_LEVEL

    def report(self, message, *args, **kwargs):
        if self.isEnabledFor(REPORT_LEVEL):
            self._log(REPORT_LEVEL, message, args, **kwargs)

    logging.Logger.report = report


class LoggerFormatter(logging.Formatter):
    """Per-level formats: REPORT rows print bare, others get level tags."""

    FORMATS = {
        logging.DEBUG: "DEBUG: %(module)s: %(lineno)d: %(message)s",
        logging.INFO: "INFO: %(message)s",
        REPORT_LEVEL: "%(message)s",
        logging.WARNING: "WARNING: %(message)s",
        logging.ERROR: "ERROR: %(message)s",
        logging.CRITICAL: "CRITICAL: %(message)s",
    }

    def format(self, record):
        fmt = self.FORMATS.get(record.levelno, "%(levelname)s: %(message)s")
        return logging.Formatter(fmt).format(record)


def init_logger(
    logger: logging.Logger | None = None,
    level: int = logging.INFO,
    stream: bool = True,
    outfname: str | None = None,
) -> logging.Logger:
    """Configure stdout + optional .log file handlers (reference:
    blues/reporters.py:88-126)."""
    add_report_level()
    if logger is None:
        logger = logging.getLogger("blues_tpu_torch")
    logger.setLevel(level)
    logger.handlers = []
    fmt = LoggerFormatter()
    if stream:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if outfname:
        fh = logging.FileHandler(outfname + ".log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
