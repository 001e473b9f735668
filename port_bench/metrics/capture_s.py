"""Seconds the set-up's first solve spent capturing CUDA graphs (the fused
loop's, or the host loop's regions): ``graph_capture_time_in_seconds``.
Nothing where that solve captured nothing."""


def read(records):
    seconds = records["setup"]["capture_s"]
    return seconds if seconds > 0 else None
