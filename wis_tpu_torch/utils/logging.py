"""Logging setup (port of ``wis_tpu/utils/logging.py``).

One root configurator honouring the LOG_LEVEL environment variable. The
root floor is INFO: LOG_LEVEL=debug reaches the app logger only, named
``wis_tpu_torch`` as every module of the port logs under, so third-party
DEBUG output stays out; LOG_LEVEL=warning or error quiets third-party INFO
output too (root = max(INFO, requested)).
"""

from __future__ import annotations

import logging
import os


def configure_logging(level: str | None = None) -> logging.Logger:
    level = (level or os.environ.get("LOG_LEVEL", "info")).upper()
    requested = getattr(logging, level, logging.INFO)
    logging.basicConfig(
        level=max(logging.INFO, requested),
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s",
    )
    logger = logging.getLogger("wis_tpu_torch")
    logger.setLevel(requested)
    return logger
