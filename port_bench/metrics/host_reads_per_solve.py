"""Operations that waited for the card (reads to the host and copies from
it, ``yardstick.HostReads``) from ``write_back`` to ``state``, over the
window's solves. Counted in the traced run only."""


def read(records):
    solves = records["solves"]
    if not solves or any(s.host_reads is None for s in solves):
        return None
    return sum(s.host_reads for s in solves) / len(solves)
