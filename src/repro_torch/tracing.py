"""Profiler spans over the port's host work.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records, and one shared no-op context otherwise: an untraced run
pays one flag check a span and dispatches no ``record_function``.  A span
keeps no clock of its own; it lands on the profiler's timeline, beside
the device's kernels and copies.

A span encloses host work only — no copy to or from the card, no launch,
no synchronising read.  The profiler mirrors a range that holds device
work as a device event of the span's name, which a reader of the trace
would count as device time.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` on the profiler's timeline while one
    records; the shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
