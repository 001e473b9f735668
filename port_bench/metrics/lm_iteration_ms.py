"""Milliseconds an LM iteration: the window's solves' minimizer seconds
(``minimizer_time_in_seconds``) over their LM iterations."""


def read(records):
    solves = records["solves"]
    iterations = sum(s.iterations for s in solves)
    if not iterations:
        return None
    return 1e3 * sum(s.minimizer_s for s in solves) / iterations
