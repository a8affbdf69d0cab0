"""Structured logging.

The reference logs only in the API (app.py:22-23) and prints everywhere
else; here every subsystem logs through one namespaced logger.
"""

from __future__ import annotations

import logging

_CONFIGURED = False


def get_logger(name: str = "cid_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
        _CONFIGURED = True
    return logging.getLogger(name)
