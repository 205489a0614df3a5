"""Accumulating wall-clock timers (the reference's utils.timer,
general_application_utils.py:487-511).

Counterpart of rigidmultiblobswall_tpu/utils/timer.py, the same host
code."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

_TOTALS = defaultdict(float)
_STARTS = {}


def timer(name, print_one=False, clean_all=False):
    """Toggle-style timer: first call starts, second call stops and
    accumulates. Matches the reference semantics."""
    if clean_all:
        _TOTALS.clear()
        _STARTS.clear()
        return
    now = time.perf_counter()
    if name in _STARTS:
        _TOTALS[name] += now - _STARTS.pop(name)
        if print_one:
            print(f"{name} = {_TOTALS[name]}")
    else:
        _STARTS[name] = now


@contextmanager
def timed(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TOTALS[name] += time.perf_counter() - t0


def totals():
    return dict(_TOTALS)


def print_all():
    for name in sorted(_TOTALS):
        print(f"{name} = {_TOTALS[name]}")
