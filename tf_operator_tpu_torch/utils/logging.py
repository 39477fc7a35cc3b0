"""Structured per-component loggers: the port's copy of what it uses of
tf_operator_tpu/utils/logging.py (which imports no JAX, but lives in the
JAX package).  Same root logger, so one `configure` of the operator's
logging covers both packages."""
from __future__ import annotations

import logging
from typing import Any, Dict

_root = logging.getLogger("tpu_operator")


class ContextLogger(logging.LoggerAdapter):
    def process(self, msg, kwargs):
        kwargs.setdefault("extra", {})["ctx"] = self.extra
        return msg, kwargs


def logger_with(ctx: Dict[str, Any]) -> ContextLogger:
    return ContextLogger(_root, ctx)


def get_logger(component: str) -> ContextLogger:
    return logger_with({"component": component})
