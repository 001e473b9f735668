"""K4's share of its roofline: the least time the card could take for one
call of the pair-cell reduction W'M^-1W (``ops/outer_segment_sum.py``; its
bytes and operations from the scene's visibility and the dtype,
``yardstick.k4_bytes``; bound by bytes at 3.35 TB/s) over the mean device
time of its kernel's calls in the trace. Nothing where no call was traced."""

import re

from port_bench import yardstick

# The kernels of csrc/outer_segment_sum.cu (compile-time and run-time forms).
KERNEL = re.compile(r"\b(tiled_kernel|general_kernel)<")


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    calls = trace.kernel_seconds(lambda name: KERNEL.search(name) is not None)
    if not calls:
        return None
    sc, e = records["scene"], records["element_bytes"]
    num_bytes, flops = yardstick.k4_bytes(
        yardstick.k4_visibility(sc.camera_index, sc.point_index), e)
    bound, _ = yardstick.bound_seconds(num_bytes, flops, e)
    return 100.0 * bound / (sum(calls) / len(calls))
