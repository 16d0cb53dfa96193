"""Device operations (kernels, copies, memsets) a frame in the traced
segment."""


def read(run):
    t = run.trace
    if not t or t["device_ops"] == 0:
        return None
    return t["device_ops"] / t["frames"]
