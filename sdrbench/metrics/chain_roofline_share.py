"""The whole chain's share of the card's peak: the configuration's least
time a frame (``sdrbench/cost``, against ``sdrbench/peaks``) over the card's
busy time a frame in the traced segment, in %."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * run.least_s_per_frame() / (t["busy_s"] / t["frames"])
