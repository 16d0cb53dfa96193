"""Run one cell of the benchmark once.

    python3 -m sdrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; everything
that belongs to it is found by name: the configuration
(``sdrbench/configs/<config>.json``, its ``program`` module in
``sdrbench/programs/``), the traffic (``sdrbench/traffic/<traffic>.json``),
the plain reference and the cost (``sdrbench/reference/<config>.py``,
``sdrbench/cost/<config>.py``) and each metric's reader
(``sdrbench/metrics/<metric>.py``).

A run makes the configuration's capture on the card from the seed, builds
and compiles the cell's one program (``Pipeline.compile``, a CUDA graph of K
frames), warms it up, then drives the window: closed loop, each dispatch
``carry, y = fn(carry, x)`` on the next K frames of the capture (a view;
the capture wraps, the carry chained across the wrap), at most ``ahead``
dispatches in flight. After the window a sample of its outputs, drawn
from the seed, is compared with the plain reference. ``--trace 1`` adds a
segment under ``torch.profiler`` after the window and reports the
per-layer metrics instead of the end-to-end ones. The last line of standard output is the
result, one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.

With no card, or fewer than the cell asks for, the run exits with code 2
and prints no result. If ``jax``, ``jaxlib``, ``flax`` or the JAX package is
loaded by the end of the run it exits with code 3 and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()      # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "futuresdr_tpu")
PROFILER_WARMUP = 4            # dispatches traced and thrown away first


def cache_env(root: Path) -> None:
    """Point every build and kernel cache the program could use at a fixed
    directory inside the checkout (the port's own kernels build into
    ``build/kernels`` there already)."""
    base = root / "build" / "sdrbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    the modules found by their names."""

    def __init__(self, root: Path, workload: str):
        self.root = root
        bench = json.loads((root / "BENCHMARK.json").read_text())
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        name = self.workload["config"]
        files = {c["name"]: c["file"] for c in bench["configs"]}
        self.config = json.loads((root / files[name]).read_text())
        self.traffic = json.loads(
            (root / "sdrbench" / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.chips = int(self.workload["chips"])
        self.program = importlib.import_module(f"sdrbench.programs.{self.config['program']}")
        self.reference = importlib.import_module(f"sdrbench.reference.{name}")
        self.cost = importlib.import_module(f"sdrbench.cost.{name}")
        self.metrics = {kind: [m for m in bench[kind] if workload in m.get("workloads", [workload])]
                        for kind in ("end_to_end", "per_layer")}
        self.readers = {m["name"]: importlib.import_module(f"sdrbench.metrics.{m['name']}")
                        for ms in self.metrics.values() for m in ms}


class _HostEvent:
    """``torch.cuda.Event``'s surface on the host clock (a run on the CPU)."""

    def __init__(self):
        self.t = 0.0

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Loop:
    """The closed loop over the capture: the program, its carry and the
    stream position."""

    def __init__(self, cell: Cell, capture, device, wrap=None):
        import torch

        from futuresdr_tpu_torch.ops import Pipeline
        t = cell.traffic
        self.cell, self.capture, self.device = cell, capture, device
        self.frame, self.k, self.ahead = int(t["frame"]), int(t["k"]), int(t["ahead"])
        self.n = self.frame * self.k
        if capture.shape[0] % self.n:
            raise ValueError(f"the capture ({capture.shape[0]}) is not a whole number of "
                             f"dispatches of {self.n}")
        stages, dtype = cell.program.stages(cell.config)
        self.fn, self.carry = Pipeline(stages, dtype).compile(self.frame, device, k=self.k)
        if wrap is not None:                      # a test's broken program
            self.fn = wrap(self.fn)
        self.pos = 0                              # stream index of the next dispatch
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.pool: list = []

    def _event(self):
        import torch
        if self.pool:
            return self.pool.pop()
        return torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()

    def send(self) -> dict:
        """Hand the next K frames to the program."""
        at = self.pos % self.capture.shape[0]
        x = self.capture[at:at + self.n].view(self.k, self.frame) if self.k > 1 \
            else self.capture[at:at + self.n]
        handoff, start, end = self._event(), self._event(), self._event()
        handoff.record(self.side)
        start.record()
        t0 = time.perf_counter()
        self.carry, y = self.fn(self.carry, x)
        call_us = (time.perf_counter() - t0) * 1e6
        end.record()
        rec = {"pos": self.pos, "n": self.n, "y": y, "events": (handoff, start, end),
               "call_us": call_us}
        self.pos += self.n
        return rec

    def finish(self, rec: dict) -> dict:
        """Wait for a dispatch on the card; its latency and card time (ms)."""
        handoff, start, end = rec.pop("events")
        end.synchronize()
        rec["latency_ms"] = handoff.elapsed_time(end)
        rec["card_ms"] = start.elapsed_time(end)
        self.pool.extend((handoff, start, end))
        return rec

    def run(self, dispatches: Optional[int] = None, seconds: Optional[float] = None,
            spans: Optional[list] = None, keep=None) -> dict:
        """Drive ``dispatches`` dispatches, or as many as start within
        ``seconds``; returns the window's records. ``keep(rec)`` sees each
        finished dispatch, its output included. ``spans``, a list, receives
        ``(name, start_ns, end_ns)`` of each call and wait on the clock the
        profiler's trace is on."""
        import contextlib

        @contextlib.contextmanager
        def span(name):
            if spans is None:
                yield
                return
            t0 = time.time_ns()
            yield
            spans.append((name, t0, time.time_ns()))
        inflight: deque = deque()
        out = {"latency_ms": [], "card_ms": [], "call_us": []}
        t0 = time.perf_counter()
        sent = 0

        def complete(rec):
            with span("wait"):
                rec = self.finish(rec)
            out["latency_ms"].append(rec["latency_ms"])
            out["card_ms"].append(rec["card_ms"])
            out["call_us"].append(rec["call_us"])
            if keep is not None:
                keep(rec)

        while (sent < dispatches) if dispatches is not None \
                else (time.perf_counter() - t0 < seconds):
            with span("call"):
                inflight.append(self.send())
            sent += 1
            if len(inflight) >= self.ahead:
                complete(inflight.popleft())
        while inflight:
            complete(inflight.popleft())
        out["seconds"] = time.perf_counter() - t0
        out["dispatches"] = sent
        return out


class Keeper:
    """Which of the window's outputs the check compares: a sample drawn from
    the seed (reservoir sampling over the window), the first dispatch
    after the capture's first wrap, and the last."""

    def __init__(self, size: int, seed: int, capture_len: int, first_pos: int):
        import numpy as np
        self.size = size
        self.rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xC4E])
        self.capture_len, self.first_pos = capture_len, first_pos
        self.seen = 0
        self.sample: list = []
        self.wrap = None
        self.last = None

    def __call__(self, rec) -> None:
        pos = rec["pos"]
        if self.wrap is None and pos > self.first_pos and pos % self.capture_len == 0:
            self.wrap = rec
        self.last = rec
        self.seen += 1
        if len(self.sample) < self.size:
            self.sample.append(rec)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.sample[j] = rec

    def records(self) -> list:
        chosen = {r["pos"]: r for r in self.sample + [self.wrap, self.last] if r is not None}
        return [chosen[p] for p in sorted(chosen)]


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=False)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def check(cell: Cell, capture, records: list) -> dict:
    """The numbers compared: the program's kept outputs against the plain
    reference over the same stream positions."""
    return cell.reference.compare(
        ((r["y"], cell.reference.expected(capture, cell.config, r["pos"], r["n"]))
         for r in records), cell.config)


def loaded_forbidden() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: Optional[dict] = None, wrap=None,
             state: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result (the last line's object) with
    the check's numbers under ``checks``. ``device`` None takes the card and
    refuses to run without one; a test passes ``torch.device("cpu")``,
    ``overrides`` (``capture_samples``, traffic keys) for a tiny run, and
    ``wrap`` to break the program underneath. ``state``, a dict, receives
    the capture and the kept outputs for a control run."""
    cell = Cell(root, workload)
    if overrides:
        cell.traffic.update({k: v for k, v in overrides.items() if k != "capture_samples"})
    import torch

    import futuresdr_tpu_torch.ops  # noqa: F401  (the port's import counts as one)
    torch.set_num_threads(2)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"sdrbench: the cell needs {cell.chips} CUDA device(s), found {count}",
                  file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        print(f"card: {power_limit()}", flush=True)
    marks = [("imports", time.perf_counter())]
    torch.empty(1, device=device)
    marks.append(("device", time.perf_counter()))
    from sdrbench import capture as capture_mod
    samples = (overrides or {}).get("capture_samples")
    capture = capture_mod.make(cell.config["capture"], seed, device, samples)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("capture", time.perf_counter()))
    drv = Loop(cell, capture, device, wrap)
    marks.append(("compile", time.perf_counter()))
    drv.run(dispatches=int(cell.traffic["warmup_dispatches"]))
    keeper = Keeper(int(cell.traffic["check_dispatches"]), seed, capture.shape[0], drv.pos)
    if drv.cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - _T0
    marks.append(("warm-up", time.perf_counter()))
    print("set-up s: " + ", ".join(f"{name} {t - prev:.3f}" for (name, t), (_, prev) in
                                   zip(marks, [("start", _T0)] + marks[:-1])), flush=True)
    window = drv.run(seconds=seconds, keep=keeper)
    card = sorted(window["card_ms"])
    print(f"window: {window['dispatches']} dispatches in {window['seconds']:.6f} s; card ms a "
          f"dispatch mean {sum(card) / len(card):.6f} median {card[len(card) // 2]:.6f} "
          f"max {card[-1]:.6f}; card share {sum(card) / 1e3 / window['seconds']:.6f}",
          flush=True)
    tenths = [sorted(part)[len(part) // 2] for part in
              (window["card_ms"][i * len(card) // 10:(i + 1) * len(card) // 10]
               for i in range(10)) if part]
    print("window: card ms median by tenth " + " ".join(f"{v:.4f}" for v in tenths), flush=True)
    traced = traced_segment(drv, int(cell.traffic["trace_dispatches"])) if trace else None
    memory_peak = torch.cuda.max_memory_allocated(device) if drv.cuda else 0
    records = keeper.records()
    del drv, keeper
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cell, capture, records)
    if state is not None:
        state.update(capture=capture, records=records, cell=cell)
    limits = cell.reference.LIMITS
    correct = all(numbers[k] <= limits[k] for k in limits)
    run = Run(cell, setup_s, window, traced, device.type == "cuda")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": window["dispatches"] * run.k,
              "failed": 0, "metrics": metrics, "device": dev}
    if traced is not None:
        print(f"traced: {traced['frames']} frames in {traced['window_s']:.6f} s, busy "
              f"{traced['busy_s']:.6f} s, {traced['device_ops']} operations; host us a call "
              f"{traced.get('call_us', 0):.3f}, card us a dispatch {traced.get('card_us', 0):.3f}; "
              f"operations outside the segment {traced.get('outside', 0)}; the longest gaps start at "
              f"{', '.join(f'{t:.4f}' for t in traced.get('gaps_at', [])[:4])} s", flush=True)
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["top"], "idle_gaps": traced["gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


class Run:
    """What a metric's reader reads: the cell, the set-up time, the window's
    records and, in a traced run, the traced segment's summary."""

    def __init__(self, cell: Cell, setup_s: float, window: dict, traced: Optional[dict],
                 on_card: bool):
        self.cell, self.setup_s, self.window, self.trace = cell, setup_s, window, traced
        self.on_card = on_card            # False: CUDA-event readings are the host's
        self.k = int(cell.traffic["k"])
        self.frame = int(cell.traffic["frame"])

    def least_s_per_frame(self) -> float:
        from sdrbench import peaks
        return peaks.least_seconds(*self.cell.cost.frame(self.cell.config, self.frame))


def traced_segment(drv: Loop, dispatches: int) -> dict:
    """``dispatches`` more dispatches with the card under ``torch.profiler``
    (CUDA activity alone: tracing the host's every op as well slowed each
    call several times over). Python's collector runs a full collection
    first: one takes a few tenths of a second in this process, and where
    it fell inside the segment it read as a third of the segment idle; the
    untraced window keeps its collections at their own rate. The session
    starts with a few dispatches whose operations are left out, which pay
    the profiler's start-up; the segment is the host-clock interval of the
    rest, and only operations that start inside it count. Returns the
    trace's summary with the segment's length, frame count and the host's
    and card's mean times a dispatch inside it. Idle gaps are named by the
    benchmark's own span (call, wait) open when each began."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdrbench import trace
    if not drv.cuda:
        seg = drv.run(dispatches=dispatches, spans=[])
        return {"busy_s": 0.0, "device_ops": 0, "top": [], "gaps": [],
                "window_s": seg["seconds"], "dispatches": seg["dispatches"],
                "frames": seg["dispatches"] * drv.k}
    gc.collect()
    spans: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        drv.run(dispatches=PROFILER_WARMUP)
        torch.cuda.synchronize(drv.device)
        t0 = time.time_ns()
        seg = drv.run(dispatches=dispatches, spans=spans)
        t1 = time.time_ns()
    summary = trace.summarize(prof, spans, t0, t1)
    summary["window_s"] = (t1 - t0) * 1e-9
    summary["dispatches"] = seg["dispatches"]
    summary["frames"] = seg["dispatches"] * drv.k
    summary["call_us"] = sum(seg["call_us"]) / len(seg["call_us"])
    summary["card_us"] = 1e3 * sum(seg["card_ms"]) / len(seg["card_ms"])
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_env(ROOT)
    result = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"sdrbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"frames in the window: {result['attempted']}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
