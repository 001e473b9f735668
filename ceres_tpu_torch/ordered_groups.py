"""OrderedGroups / ParameterBlockOrdering: user elimination-order hints
(port of ``ceres_tpu/ordered_groups.py``, host only).

API parity with ``include/ceres/ordered_groups.h:1-197``: elements
(parameter-block ids) are assigned to non-negative groups; lower group
numbers are eliminated first. Used as ``SolverOptions.linear_solver_ordering``:
group 0 = the e-blocks the Schur eliminator removes first
(reorder_program.cc:446); the remaining groups order the reduced system (a
fill-in concern for the reference's sparse factorizations; numerically
inert for the dense and iterative reduced solves, but validated for API
parity). ``validate_independent_set`` is the check of an inner-iteration
ordering (coordinate_descent_minimizer.cc).

Plain lists-of-lists are accepted anywhere an OrderedGroups is: index i of
the list is group i.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class OrderedGroups:
    """Analog of ceres::internal::OrderedGroups<int> (ordered_groups.h)."""

    def __init__(self):
        self._group_of: Dict[int, int] = {}

    def add_element_to_group(self, element: int, group: int) -> None:
        if group < 0:
            raise ValueError("group id must be non-negative")
        self._group_of[int(element)] = int(group)

    def remove_element(self, element: int) -> bool:
        return self._group_of.pop(int(element), None) is not None

    def reverse(self) -> None:
        """ordered_groups.h Reverse(): flip the elimination order."""
        if not self._group_of:
            return
        hi = max(self._group_of.values())
        lo = min(self._group_of.values())
        for el, g in self._group_of.items():
            self._group_of[el] = hi - (g - lo)

    def group(self, element: int) -> int:
        """Return the element's group or -1 (GroupId semantics)."""
        return self._group_of.get(int(element), -1)

    def is_member(self, element: int) -> bool:
        return int(element) in self._group_of

    def group_size(self, group: int) -> int:
        return sum(1 for g in self._group_of.values() if g == int(group))

    @property
    def num_elements(self) -> int:
        return len(self._group_of)

    @property
    def num_groups(self) -> int:
        return len(set(self._group_of.values()))

    def min_non_zero_group(self) -> int:
        """ordered_groups.h MinNonZeroGroup (errors when empty)."""
        nz = [g for g in self._group_of.values() if g != 0]
        if not nz:
            raise ValueError("no non-zero groups")
        return min(nz)

    def group_to_elements(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for el, g in sorted(self._group_of.items()):
            out.setdefault(g, []).append(el)
        return dict(sorted(out.items()))

    def as_group_list(self) -> List[List[int]]:
        """Groups as a dense list ordered by ascending group id."""
        return [els for _, els in sorted(self.group_to_elements().items())]


def normalize_ordering(ordering) -> Optional[List[List[int]]]:
    """Accept OrderedGroups | list-of-lists | None -> list of groups."""
    if ordering is None:
        return None
    if isinstance(ordering, OrderedGroups):
        return ordering.as_group_list()
    return [list(g) for g in ordering]


def validate_ordering_partition(program, groups: Sequence[Sequence[int]]):
    """The reference requires the ordering to cover every active
    parameter block exactly once (reorder_program.cc / solver.cc
    preprocessing error). Raises ValueError otherwise."""
    seen: Dict[int, int] = {}
    for gi, g in enumerate(groups):
        for pid in g:
            pid = int(pid)
            if pid in seen:
                raise ValueError(
                    f"parameter block {pid} appears in ordering groups "
                    f"{seen[pid]} and {gi}"
                )
            seen[pid] = gi
    active = set(np.nonzero(program.active)[0].tolist())
    missing = active - seen.keys()
    if missing:
        raise ValueError(
            "ordering must contain every active parameter block; missing "
            f"{sorted(missing)[:5]}{'...' if len(missing) > 5 else ''}"
        )


def validate_independent_set(program, group: Sequence[int]) -> None:
    """CoordinateDescentMinimizer::IsOrderingValid: no two blocks of a
    group may share a residual block. Raises ValueError otherwise."""
    gs = {int(p) for p in group}
    for fam in program.families:
        for row in np.asarray(fam.block_ids):
            hits = [int(p) for p in row if int(p) in gs]
            if len(set(hits)) > 1:
                raise ValueError(
                    "inner-iteration ordering group is not an independent "
                    f"set: blocks {sorted(set(hits))} share a residual"
                )
