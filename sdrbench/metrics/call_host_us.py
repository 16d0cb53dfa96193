"""The host's time in one call of the program (``CompiledPipeline.__call__``:
the copy in, the graph's replay, the clone out), the mean over the
window's dispatches, by the benchmark's clock around the call."""


def read(run):
    calls = run.window["call_us"]
    return sum(calls) / len(calls) if calls else None
