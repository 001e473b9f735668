"""Linear solver (PCG) iterations a solve: the window's solves'
``num_linear_solver_iterations`` over their number."""


def read(records):
    solves = records["solves"]
    if not solves:
        return None
    return sum(s.linear_iterations for s in solves) / len(solves)
