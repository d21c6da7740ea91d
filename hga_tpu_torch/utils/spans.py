"""Spans and counters: the port's one tracing mechanism.

A span names a stretch of host code:

    with spans.span("spectrum.h2d") as sp:
        ...
    sp.seconds          # the stretch's seconds on the host's clock

While a ``torch.profiler`` session records (the CLI's ``--profile DIR``, or
a traced benchmark run), a span also opens ``record_function(name)``: it
lands as a ``user_annotation`` event in the same trace as the device's
kernels and copies, on their clock, nested under the span that encloses it.
Otherwise it reads the clock twice and does nothing more.  No span
synchronises the device or formats a string; there is no switch besides the
profiler itself.

Counters are integers in one registry of the process, by name, added to
with ``count`` and read with ``counters`` (a snapshot).  Names are dotted,
their first part the layer: ``spectrum.*``, ``launch.*`` (each kernel
wrapper's launches, by route), and spans only: ``evalseg.*``, ``stage.*``
(the pipeline's stages).

A kernel wrapper names its launch by the kernel's route alone:

    with spans.launch("myers_batch_cuda_shared"):
        run_kernel(...)

opens the span ``launch.myers_batch_cuda_shared`` and, once the block has
run, adds one to the counter of that name; ``launches()`` reads them back by
route.
"""

from __future__ import annotations

import collections
import time
from typing import Counter, Optional

import torch
import torch.autograd.profiler as _profiler

_COUNTS: Counter[str] = collections.Counter()
LAUNCH = "launch."           # the prefix of the launches' spans and counters
_LAUNCH_NAMES: dict = {}     # route -> LAUNCH + route


class span:
    """A named stretch of host code; ``.seconds`` once it has ended."""

    __slots__ = ("name", "seconds", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._rf: Optional[torch.profiler.record_function] = None

    def __enter__(self) -> "span":
        # a module-level bool; record_function costs ~10 us a call even
        # with no profiler on
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class launch(span):
    """A kernel route's launches: the span ``launch.<route>``, and the
    counter of that name moved by ``.n`` (1, or what a block that launches
    several times sets) once the block has run without raising."""

    __slots__ = ("n",)

    def __init__(self, route: str):
        name = _LAUNCH_NAMES.get(route)
        if name is None:
            name = _LAUNCH_NAMES[route] = LAUNCH + route
        super().__init__(name)
        self.n = 1

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        if exc[0] is None:
            _COUNTS[self.name] += self.n
        return False


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _COUNTS[name] += n


def counters(prefix: str = "") -> Counter[str]:
    """A snapshot of the counters whose names start with `prefix`; a name
    never counted reads 0."""
    return collections.Counter(
        {k: v for k, v in _COUNTS.items() if k.startswith(prefix)})


def launches() -> Counter[str]:
    """A snapshot of the launch counters by route (``launch.<route>`` read
    as ``<route>``); a route never launched reads 0."""
    n = len(LAUNCH)
    return collections.Counter(
        {k[n:]: v for k, v in _COUNTS.items() if k.startswith(LAUNCH)})


def reset(prefix: str = "") -> None:
    """Drop the counters whose names start with `prefix` (all by default)."""
    for k in [k for k in _COUNTS if k.startswith(prefix)]:
        del _COUNTS[k]
