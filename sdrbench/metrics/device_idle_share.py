"""The share of the traced segment in which no operation ran on the card:
1 − busy / wall, busy the union of every device operation's interval in
``torch.profiler``'s trace, in %. The profiler slows the host's side of each
call, so this reads above what the untraced window would (PERF.md)."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
