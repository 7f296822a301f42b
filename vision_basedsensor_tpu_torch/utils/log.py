"""Logging setup shared by all stages.

The reference mixes one ``logging`` setup (``3d_reconstruction.py:38-46``)
with ad-hoc ``[INFO]``-prefixed prints everywhere else (SURVEY.md §5.5); here
every module gets a namespaced logger with one consistent format, and file
logging is opt-in (the reference crashed creating its log file before the
directory existed — quirk 4).
"""
from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name: str, logfile: str | None = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(f"vbs.{name}")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    if logfile:
        # Dedup like the stream handler: repeated calls with the same
        # logfile must not stack handlers (N-fold duplicate lines + leaked
        # file descriptors).
        path = os.path.abspath(logfile)
        already = any(isinstance(h, logging.FileHandler)
                      and getattr(h, "baseFilename", None) == path
                      for h in logger.handlers)
        if not already:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger
