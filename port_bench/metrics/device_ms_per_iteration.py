"""Device milliseconds an LM iteration in the traced part of the window:
the union of the profiler's device operations (kernels, copies, fills) over
the LM iterations of the solves traced, less what the harness launches to
draw starts (the device operations in its ``port_bench.start`` span). Read
from the trace alone; the host's clock does not enter it."""

START_SPAN = "port_bench.start"


def read(records):
    trace, traced = records["trace"], records["traced"]
    if trace is None or not traced:
        return None
    iterations = sum(s.iterations for s in traced)
    busy = trace.busy_s_outside(START_SPAN)
    if not iterations or busy <= 0.0:
        return None
    return 1e3 * busy / iterations
