from .time_units import tconvert, t_unit_map, create_savepoints
from .interpolation import TimeSeries
from .logging import logger, start_log, end_log, flush_log, with_global_logger

__all__ = [
    "tconvert", "t_unit_map", "create_savepoints", "TimeSeries",
    "logger", "start_log", "end_log", "flush_log", "with_global_logger",
]
