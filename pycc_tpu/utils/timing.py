"""Structured timing/observability layer.

The reference's tracing is bare `time.time()` prints scattered through the
solvers (SURVEY §5); here timers are structured (named, nested, aggregated)
and a `trace()` context wraps `jax.profiler` so hot loops can be profiled
on-device and inspected with TensorBoard/xprof.
"""

import contextlib
import time
from collections import defaultdict
from .log import logger as log


class Timers:
    """Named wall-clock timers with call counts: Timers.report() prints an
    aggregate table.  `first` keeps each timer's first call apart, since
    that call includes compiling the programs it dispatches."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.first = {}

    @contextlib.contextmanager
    def time(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.first.setdefault(name, dt)

    def report(self):
        lines = ["%-30s %10s %8s" % ("timer", "total(s)", "calls")]
        for name in sorted(self.total, key=self.total.get, reverse=True):
            lines.append("%-30s %10.3f %8d"
                         % (name, self.total[name], self.count[name]))
        out = "\n".join(lines)
        log.info(out)
        return out


timers = Timers()


@contextlib.contextmanager
def trace(logdir="/tmp/pycc_tpu_trace"):
    """Profile the enclosed block with jax.profiler (view with xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
