"""Observability for the port: the span tracer."""

from . import trace
from .trace import Tracer

__all__ = ["Tracer", "trace"]
