"""Reporters (stream rows, AMBER NetCDF, HDF5, restart, progress) and the logging setup."""

from .logger import init_logger, add_report_level, LoggerFormatter, REPORT_LEVEL
from .reporters import (
    BaseReporter, StateDataReporter, NetCDFReporter, HDF5Reporter,
    RestartReporter, ProgressReporter, ReporterConfig,
)
