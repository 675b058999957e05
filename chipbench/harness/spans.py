"""Host spans the benchmark records around its own calls into the
program.  Kept in memory; with tracing on, each span is also a
`record_function` range, so the device trace can say what the host was
doing while the card sat idle."""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Tuple

#: prefix of the benchmark's ranges in a profiler trace
PREFIX = "chipbench."


class Spans:
    def __init__(self, traced: bool) -> None:
        self.traced = traced
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        rf = None
        if self.traced:
            from torch.profiler import record_function
            rf = record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def durations(self, name: str, since: float = float("-inf"),
                  until: float = float("inf")) -> List[float]:
        """Seconds of every `name` span that began in [since, until)."""
        return [b - a for n, a, b in self.items
                if n == name and since <= a < until]
