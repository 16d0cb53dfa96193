"""The card's busy time for one dispatch (one replay of the graph with the
call's copy in and clone out): the union of the device operations'
intervals in ``torch.profiler``'s trace of the traced segment, over its
dispatches, in µs."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 1e6 * t["busy_s"] / t["dispatches"]
