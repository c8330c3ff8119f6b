"""Logging setup: stdout plus ``<save_path>/quantization.log`` (mirrors
``tgq/utils/logging.py``)."""
from __future__ import annotations

import logging
import os
import sys


def setup_logging(save_path: str | None = None, log_level: str = "INFO") -> None:
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        handlers.append(
            logging.FileHandler(os.path.join(save_path, "quantization.log"))
        )
    logging.basicConfig(
        level=getattr(logging, log_level.upper()),
        format="[%(asctime)s] %(levelname)s: %(message)s",
        datefmt="%H:%M:%S",
        handlers=handlers,
        force=True,
    )
