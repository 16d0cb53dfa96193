"""Frame, depth, wire, megabatch-K and kernel-plan tuning, and the cache of
the picks.

The counterpart of ``futuresdr_tpu/tpu/autotune.py``. :func:`autotune`
sweeps frame size and in-flight depth through the resident program with its
transfers; the streamed tuning is two-stage: :func:`measure_link` times the
host↔card link, :func:`pick_wire` turns it into the analytic wire choice,
and :func:`autotune_streamed` measures the real streamed block
(``TpuKernel``, or the fan-out and DAG kernels) over (wire, frame, depth, K)
and records the winner. :func:`autotune_pallas_blocks` runs the kernel-plan
sweep (``tpu/kernel_tune.py``) and installs its winners.

The streamed-pick cache maps a chain's signature (the card's name, the
input dtype, the stage names without the device-chain fences, fan-out and
DAG shapes marked) to ``{"k", "inflight"}`` and the optional axes
``serve_buckets`` and ``serve_pages`` (:func:`autotune_serve`'s slot-bucket
ladder and page-pool pick, which ``serve/engine.ServeEngine`` reads),
``n_devices`` (:func:`autotune_shard`'s data-shard width),
``interior_precision``,
``pallas_blocks`` (``{device: {kernel: {shape: plan}}}``, the port's plan
tuples) and ``wire``. Every axis is parsed in its own guard, so a malformed
value loses that axis only. The memory layer is authoritative within a
process; with config ``autotune_cache_dir`` set the picks also persist as
JSON (``streamed_picks.json``), written with an atomic rename. Readers: the
device-chain pass (a fused region's cached K), ``TpuKernel`` (its credit
seed, its adaptive wire's start, its plans and the recorded precision).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..log import logger
from ..ops.stages import Pipeline, Stage
from .instance import TpuInstance, instance
from .kernel_tune import device_key

__all__ = ["autotune", "autotune_streamed", "default_frames", "measure_link",
           "pick_wire", "StreamedResults", "record_streamed_pick",
           "cached_frames_per_dispatch", "cached_streamed_pick",
           "record_interior_precision", "cached_interior_precision",
           "record_wire_start", "cached_wire_start", "record_pallas_blocks",
           "cached_pallas_blocks", "autotune_pallas_blocks", "platform_of",
           "autotune_serve", "record_serve_buckets", "cached_serve_buckets",
           "autotune_shard", "record_shard_devices", "cached_shard_devices",
           "record_serve_pages", "cached_serve_pages"]

log = logger("tpu.autotune")


def platform_of(inst_or_device) -> str:
    """The signature's platform key: the card's name, or ``"cpu"``."""
    dev = getattr(inst_or_device, "device", inst_or_device)
    return device_key(dev)


def default_frames(platform: str) -> tuple:
    """The frame grid :func:`autotune` sweeps unless pinned: up to 2^20 on
    the CPU, 2^21 on a card."""
    base = (1 << 17, 1 << 18, 1 << 19, 1 << 20)
    return base if platform == "cpu" else base + (1 << 21,)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(pipe: Pipeline, frame: int, depth: int, inst: TpuInstance,
             min_seconds: float) -> float:
    """Msamples/s through the compiled program with its H2D and D2H, at most
    ``depth`` frames in flight."""
    dev = inst.device
    fn, carry = pipe.compile(frame, dev)
    host = torch.zeros(frame, dtype=_torch_dtype(pipe.in_dtype))
    if dev.type == "cuda":
        host = host.pin_memory()

    def put():
        return host.to(dev, non_blocking=True)

    carry, y = fn(carry, put())                  # warm-up
    _host_out(y)
    inflight, n_frames = [], 0
    t0 = time.perf_counter()
    while True:
        carry, y = fn(carry, put())
        inflight.append(y)
        n_frames += 1
        if len(inflight) >= depth:
            _host_out(inflight.pop(0))
        if n_frames % 4 == 0 and time.perf_counter() - t0 > min_seconds:
            break
        if n_frames > 10000:
            break
    for y in inflight:
        _host_out(y)
    return n_frames * frame / (time.perf_counter() - t0) / 1e6


def _host_out(y):
    if isinstance(y, tuple):
        return tuple(t.cpu() for t in y)
    return y.cpu()


def _torch_dtype(dt) -> torch.dtype:
    from ..ops.xfer import torch_dtype
    return torch_dtype(dt)


def autotune(stages: Sequence[Stage], in_dtype, frames: Optional[Sequence[int]] = None,
             depths: Sequence[int] = (2, 4, 8), min_seconds: float = 0.3,
             inst: Optional[TpuInstance] = None) -> Tuple[int, int, Dict]:
    """``(best_frame, best_depth, {(frame, depth): Msps})`` of the resident
    program with its transfers (``frames=None``: :func:`default_frames`)."""
    inst = inst or instance()
    if frames is None:
        frames = default_frames(platform_of(inst))
    results: Dict[Tuple[int, int], float] = {}
    best, best_rate = (0, 0), -1.0
    for f in frames:
        m = Pipeline(list(stages), in_dtype).frame_multiple
        f = max(m, (f // m) * m)
        for d in depths:
            try:
                rate = _measure(Pipeline(list(stages), in_dtype), f, d, inst, min_seconds)
            except (RuntimeError, ValueError) as e:     # out of memory at large frames
                log.warning("autotune (%d, %d) failed: %r", f, d, e)
                continue
            results[(f, d)] = round(rate, 1)
            if rate > best_rate:
                best_rate, best = rate, (f, d)
    log.info("autotune best: frame=%d depth=%d (%.1f Msps)", *best, best_rate)
    return best[0], best[1], results


# ---------------------------------------------------------------------------
# streamed tuning: link → wire → the measured grid point
# ---------------------------------------------------------------------------

def measure_link(inst: Optional[TpuInstance] = None, nbytes: int = 4 << 20,
                 repeats: int = 3, dtype=np.float32) -> Tuple[float, float]:
    """Measured ``(h2d_Bps, d2h_Bps)`` of the host↔device link: the median of
    ``repeats`` crossings of a pinned ``nbytes`` payload each way."""
    inst = inst or instance()
    dev = inst.device
    dt = np.dtype(dtype)
    host = torch.zeros(max(1, nbytes // dt.itemsize), dtype=_torch_dtype(dt))
    if dev.type == "cuda":
        host = host.pin_memory()
    size = host.numel() * host.element_size()
    ups, downs = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        y = host.to(dev, non_blocking=True)
        _sync(dev)
        ups.append(size / max(time.perf_counter() - t0, 1e-9))
        t0 = time.perf_counter()
        y.cpu()
        downs.append(size / max(time.perf_counter() - t0, 1e-9))
    return sorted(ups)[repeats // 2], sorted(downs)[repeats // 2]


def pick_wire(h2d_Bps: float, d2h_Bps: float, in_dtype, out_dtype,
              out_per_in: float = 1.0, compute_msps: Optional[float] = None,
              min_snr_db: Optional[float] = 60.0,
              wires: Optional[Sequence[str]] = None) -> str:
    """The analytic wire choice from a measured link: each format's streamed
    ceiling ``min(h2d/up_bytes, d2h/down_bytes, compute)``, formats whose
    measured codec SNR is under ``min_snr_db`` left out; ties (to 0.01 Msps)
    go to the higher SNR."""
    from ..ops.wire import get_wire, measure_snr_db, streamed_ceiling_msps
    cand = []
    for name in (wires or ("f32", "sc16", "sc8", "bf16")):
        w = get_wire(name)
        snr = measure_snr_db(w, in_dtype)
        if min_snr_db is not None and snr < min_snr_db:
            continue
        ceil = streamed_ceiling_msps(w, h2d_Bps, d2h_Bps, in_dtype, out_dtype, out_per_in)
        if compute_msps:
            ceil = min(ceil, compute_msps)
        cand.append((ceil, snr, w.name))
    if not cand:
        return "f32"
    cand.sort(key=lambda c: (round(c[0], 2), c[1]), reverse=True)
    return cand[0][2]


def _measure_wired(pipe, wire, frame: int, depth: int, inst: TpuInstance,
                   min_seconds: float, k: int = 1) -> float:
    """Msamples/s of the real streamed block: ``NullSource → Head → TpuKernel
    (or the fan-out/DAG kernel) → NullSink`` at this wire, frame, depth and
    K, with at least ``min_seconds`` of input (estimated from a first run)."""
    from ..blocks import Head, NullSink, NullSource
    from ..runtime import Flowgraph, Runtime
    from .kernel_block import TpuDagKernel, TpuFanoutKernel, TpuKernel

    def run(n_frames: int) -> float:
        fg = Flowgraph()
        src = NullSource(pipe.in_dtype)
        head = Head(pipe.in_dtype, n_frames * frame)
        if getattr(pipe, "n_branches", 0):
            cls = TpuDagKernel if hasattr(pipe, "sinks") else TpuFanoutKernel
            tk = cls(pipe, frame_size=frame, inst=inst, frames_in_flight=depth,
                     frames_per_dispatch=k, wire=wire)
            fg.connect(src, head, tk)
            for j, dt in enumerate(pipe.out_dtypes):
                fg.connect_stream(tk, f"out{j}", NullSink(dt), "in")
        else:
            tk = TpuKernel((), pipe.in_dtype, frame_size=frame, inst=inst,
                           frames_in_flight=depth, frames_per_dispatch=k, wire=wire,
                           _pipeline=pipe)
            fg.connect(src, head, tk, NullSink(pipe.out_dtype))
        t0 = time.perf_counter()
        Runtime().run(fg)
        return time.perf_counter() - t0

    first = 4 * k
    dt = run(first)
    n = max(first, int(first * min_seconds / max(dt, 1e-6)) // k * k)
    n = min(n, 4096)
    dt = run(n)
    return n * frame / dt / 1e6


class StreamedResults(dict):
    """``autotune_streamed``'s matrix ``{(wire, frame, depth, k): Msps}``,
    the winner's K as ``frames_per_dispatch`` and depth as
    ``frames_in_flight``."""

    frames_per_dispatch: int = 1
    frames_in_flight: int = 0


def autotune_streamed(stages, in_dtype, wires: Optional[Sequence[str]] = None,
                      frames: Optional[Sequence[int]] = None,
                      depths: Sequence[int] = (2, 4, 8), ks: Sequence[int] = (1, 4),
                      min_seconds: float = 0.3, min_snr_db: Optional[float] = 60.0,
                      inst: Optional[TpuInstance] = None) -> Tuple[str, int, int, Dict]:
    """``(best_wire, best_frame, best_depth, results)`` of the streamed path
    over (wire, frame, depth, K); the winner is recorded in the cache under
    the chain's signature (a linear chain under its raw and its optimized
    stage lists; a fan-out under its shape and its raw lists; a DAG under
    its canonical shape). ``stages`` may be a ``FanoutPipeline`` or
    ``DagPipeline``. An explicit config ``tpu_wire_format`` pins the wire;
    else the candidates are f32 and :func:`pick_wire`'s pick."""
    from ..config import config
    from ..ops.stages import DagPipeline, FanoutPipeline
    inst = inst or instance()
    plat = platform_of(inst)
    pipe = stages if isinstance(stages, (FanoutPipeline, DagPipeline)) \
        else Pipeline(list(stages), in_dtype)
    if wires is None:
        pinned = str(config().tpu_wire_format)
        if pinned != "auto":
            wires = (pinned,)
        else:
            up, down = measure_link(inst)
            if getattr(pipe, "n_branches", 0):
                base = np.dtype(pipe.out_dtypes[0]).itemsize
                out_per_in = float(sum(float(r) * (np.dtype(dt).itemsize / base)
                                       for r, dt in zip(pipe.path_ratios, pipe.out_dtypes)))
            else:
                out_per_in = float(pipe.ratio)
            picked = pick_wire(up, down, pipe.in_dtype, pipe.out_dtype, out_per_in,
                               min_snr_db=min_snr_db)
            wires = ("f32",) if picked == "f32" else ("f32", picked)
    if frames is None:
        frames = default_frames(plat)
    results = StreamedResults()
    best, best_rate = ("f32", 0, 0, 1), -1.0
    m = pipe.frame_multiple
    for wname in wires:
        for f in frames:
            f = max(m, (f // m) * m)
            for d in depths:
                for k in dict.fromkeys(ks):
                    try:
                        rate = _measure_wired(pipe, wname, f, d, inst, min_seconds, k=k)
                    except (RuntimeError, ValueError) as e:
                        log.warning("autotune_streamed (%s, %d, %d, k=%d) failed: %r",
                                    wname, f, d, k, e)
                        continue
                    results[(wname, f, d, k)] = round(rate, 1)
                    if rate > best_rate:            # ties keep the earlier (K=1)
                        best_rate, best = rate, (wname, f, d, k)
    results.frames_per_dispatch = best[3]
    results.frames_in_flight = best[2]
    if isinstance(pipe, DagPipeline):
        sigs = [_streamed_sig(pipe, pipe.in_dtype, plat)]
    elif isinstance(pipe, FanoutPipeline):
        raw_p, raw_b = pipe.raw_stage_lists
        sigs = [_streamed_sig(pipe, pipe.in_dtype, plat),
                _make_sig(plat, pipe.in_dtype, _fanout_names(raw_p, raw_b))]
    else:
        sigs = [_streamed_sig(list(stages), pipe.in_dtype, plat),
                _streamed_sig(pipe.stages, pipe.in_dtype, plat)]
    for sig in dict.fromkeys(sigs):
        _record_sig(sig, best[3], inflight=best[2])
        _record_axis(sig, "wire", best[0])
    log.info("autotune_streamed best: wire=%s frame=%d depth=%d k=%d (%.1f Msps)",
             *best, best_rate)
    return best[0], best[1], best[2], results


# ---------------------------------------------------------------------------
# the streamed-pick cache
# ---------------------------------------------------------------------------

_streamed_cache: Dict[tuple, dict] = {}


def _sig_names(stages) -> tuple:
    return tuple(str(getattr(s, "name", "?")) for s in stages
                 if getattr(s, "name", "") != "devchain_boundary")


def _fanout_names(producer_stages, branch_stage_lists) -> tuple:
    """A fan-out's shape: producer names, then per-branch markers, so a
    1→2 region and the linear chain of its stages never share a pick."""
    names = _sig_names(producer_stages)
    for j, b in enumerate(branch_stage_lists):
        names += (f"fanout[{j}]",) + _sig_names(b)
    return names


def _dag_names(dag) -> tuple:
    """A DAG's shape, canonical: runs of single-input nodes whose producer
    has one consumer contract into one group before the ``dag[i<-inputs]``
    markers, so a device-chain region (a node a member) and a hand-built
    ``DagPipeline`` of the same stages share a pick."""
    nodes = [([s for s in sl if getattr(s, "name", "") != "devchain_boundary"],
              list(inputs)) for sl, inputs in dag.raw_nodes]
    n_cons = [0] * len(nodes)
    for _sl, ins in nodes:
        for j in ins:
            n_cons[j] += 1
    group = [0] * len(nodes)
    g_stages: Dict[int, list] = {}
    g_inputs: Dict[int, list] = {}
    next_g = 0
    for i, (sl, ins) in enumerate(nodes):
        if len(ins) == 1 and n_cons[ins[0]] == 1:
            group[i] = group[ins[0]]
            g_stages[group[i]].extend(sl)
        else:
            group[i] = next_g
            g_stages[next_g] = list(sl)
            g_inputs[next_g] = [group[j] for j in ins]
            next_g += 1
    names: tuple = ()
    for g in range(next_g):
        names += (f"dag[{g}<-{','.join(map(str, g_inputs[g]))}]",)
        names += _sig_names(g_stages[g])
    return names


def _make_sig(platform: str, in_dtype, names: tuple) -> tuple:
    """The cache key: every signature is built here."""
    return (platform, str(np.dtype(in_dtype)), names)


def _streamed_sig(stages, in_dtype, platform: str) -> tuple:
    from ..ops.stages import DagPipeline, FanoutPipeline
    if isinstance(stages, DagPipeline):
        names = _dag_names(stages)
    elif isinstance(stages, FanoutPipeline):
        names = _fanout_names(stages.producer.stages, [b.stages for b in stages.branches])
    elif isinstance(stages, Pipeline):
        names = _sig_names(stages.stages)
    else:
        names = _sig_names(stages)
    return _make_sig(platform, in_dtype, names)


def _cache_file() -> Optional[str]:
    """The persisted store (None: config ``autotune_cache_dir`` unset or off)."""
    from ..config import config
    d = str(config().autotune_cache_dir or "")
    if not d or d.lower() in ("0", "off", "none", "false"):
        return None
    return os.path.join(os.path.expanduser(d), "streamed_picks.json")


def _sig_str(sig: tuple) -> str:
    platform, dtype, names = sig
    return "|".join((platform, dtype, ",".join(names)))


def _pos_int(v) -> Optional[int]:
    v = int(v)
    return v if v >= 1 else None


def _norm_entry(v) -> Optional[dict]:
    """One cache value as ``{"k": int, "inflight": int|None}`` plus the axes
    it carries, each parsed in its own guard (a malformed axis is dropped, the
    entry's other picks stay); a bare int is a legacy K-only entry; None for
    a value with no valid K (the entry is skipped, never a launch failure)."""
    try:
        if not isinstance(v, dict):
            return {"k": int(v), "inflight": None}
        fl = v.get("inflight")
        out = {"k": int(v["k"]), "inflight": int(fl) if fl is not None else None}
    except (TypeError, ValueError, KeyError):
        return None
    sb = v.get("serve_buckets")
    if sb:
        try:
            buckets = sorted({int(b) for b in sb if int(b) > 0})
            if buckets:
                out["serve_buckets"] = buckets
        except (TypeError, ValueError):
            pass
    for axis in ("serve_pages", "n_devices"):
        if v.get(axis) is not None:
            try:
                n = _pos_int(v[axis])
                if n is not None:
                    out[axis] = n
            except (TypeError, ValueError):
                pass
    ip = v.get("interior_precision")
    if ip is not None and isinstance(ip, str):
        mode = ip.strip().lower()
        if mode in ("off", "auto", "bf16", "int8"):
            out["interior_precision"] = mode
    pb = v.get("pallas_blocks")
    if pb is not None:
        from ..ops.cuda_kernels import plans_to_json
        try:
            tbl = {}
            for dev, plans in dict(pb).items():
                good = plans_to_json(plans)
                if good:
                    tbl[str(dev)] = good
            if tbl:
                out["pallas_blocks"] = tbl
        except (TypeError, ValueError, AttributeError):
            pass
    w = v.get("wire")
    if w is not None and isinstance(w, str):
        from ..ops.wire import WIRE_FORMATS
        w = w.strip().lower()
        if w in WIRE_FORMATS:
            out["wire"] = w
    return out


#: one disk read a process (keyed by path, so a repointed autotune_cache_dir
#: reads again)
_disk_memo: Dict[str, Dict[str, dict]] = {}


def _disk_load(refresh: bool = False) -> Dict[str, dict]:
    path = _cache_file()
    if not path:
        return {}
    if not refresh and path in _disk_memo:
        return _disk_memo[path]
    out: Dict[str, dict] = {}
    try:
        with open(path) as f:
            d = json.load(f)
        if isinstance(d, dict):
            for key, v in d.items():
                entry = _norm_entry(v)
                if entry is None:
                    log.warning("streamed-pick cache: ignoring bad value %r for %r", v, key)
                else:
                    out[str(key)] = entry
    except (OSError, ValueError):
        pass
    _disk_memo[path] = out
    return out


def _disk_store(sig: tuple, entry) -> None:
    """Read-modify-write with an atomic rename: a concurrent reader sees the
    old or the new file; a lost concurrent update costs a re-measure."""
    path = _cache_file()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        d = dict(_disk_load(refresh=True))
        d[_sig_str(sig)] = entry
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(d, f, sort_keys=True, indent=0)
        os.replace(tmp, path)
        _disk_memo[path] = {k: e for k, e in
                            ((k, _norm_entry(v)) for k, v in d.items()) if e is not None}
    except OSError as e:
        log.debug("streamed-pick cache write failed: %r", e)


def _current(sig: tuple) -> dict:
    return dict(_streamed_cache.get(sig) or _disk_load().get(_sig_str(sig))
                or {"k": 1, "inflight": None})


def _record_sig(sig: tuple, frames_per_dispatch: int, inflight: Optional[int] = None) -> None:
    """Record (K, inflight) under ``sig``, keeping the other axes a previous
    record stamped there; a K-only record persists as a bare int."""
    prev = _streamed_cache.get(sig) or _disk_load().get(_sig_str(sig)) or {}
    entry = {k: v for k, v in prev.items() if k not in ("k", "inflight")}
    entry = {"k": int(frames_per_dispatch),
             "inflight": int(inflight) if inflight else None, **entry}
    _streamed_cache[sig] = entry
    _disk_store(sig, int(frames_per_dispatch)
                if not inflight and len(entry) == 2 else entry)


def _record_axis(sig: tuple, axis: str, value) -> None:
    entry = {**_current(sig), axis: value}
    _streamed_cache[sig] = entry
    _disk_store(sig, entry)


def _sig_of(stages):
    """A plain Pipeline keys on its stage list; fan-out and DAG pipelines on
    their shapes."""
    return stages.stages if isinstance(stages, Pipeline) else stages


def record_streamed_pick(stages, in_dtype, platform: str, frames_per_dispatch: int,
                         inflight: Optional[int] = None) -> None:
    _record_sig(_streamed_sig(_sig_of(stages), in_dtype, platform), frames_per_dispatch,
                inflight)


def cached_streamed_pick(stages, in_dtype, platform: str) -> Optional[dict]:
    """A tuned chain's entry (the memory layer first, then the persisted
    store); None when never tuned."""
    sig = _streamed_sig(_sig_of(stages), in_dtype, platform)
    entry = _streamed_cache.get(sig)
    if entry is not None:
        return entry
    entry = _disk_load().get(_sig_str(sig))
    if entry is not None:
        _streamed_cache[sig] = entry
    return entry


def cached_frames_per_dispatch(stages, in_dtype, platform: str) -> Optional[int]:
    entry = cached_streamed_pick(stages, in_dtype, platform)
    return entry["k"] if entry is not None else None


def record_interior_precision(stages, in_dtype, platform: str, mode: str) -> None:
    """Stamp the applied interior-precision mode on the chain's entry (a K
    measured on a lowered program does not describe a float32 rebuild);
    an unknown mode is dropped."""
    mode = str(mode).strip().lower()
    if mode in ("off", "auto", "bf16", "int8"):
        _record_axis(_streamed_sig(_sig_of(stages), in_dtype, platform),
                     "interior_precision", mode)


def cached_interior_precision(stages, in_dtype, platform: str) -> Optional[str]:
    entry = cached_streamed_pick(stages, in_dtype, platform)
    return None if entry is None else entry.get("interior_precision")


def record_wire_start(stages, in_dtype, platform: str, fmt: str) -> None:
    """Stamp the wire the last :func:`autotune_streamed` measured fastest:
    the adaptive wire's start; an unknown format is dropped."""
    from ..ops.wire import WIRE_FORMATS
    fmt = str(fmt).strip().lower()
    if fmt in WIRE_FORMATS:
        _record_axis(_streamed_sig(_sig_of(stages), in_dtype, platform), "wire", fmt)


def cached_wire_start(stages, in_dtype, platform: str) -> Optional[str]:
    entry = cached_streamed_pick(stages, in_dtype, platform)
    return None if entry is None else entry.get("wire")


def record_pallas_blocks(stages, in_dtype, platform: str, device: str, plans) -> None:
    """Stamp a sweep's plans for one card (``device``, its name) on the
    chain's entry, beside other cards' (the axis's name and place are the
    JAX package's, its values the port's plans); what
    ``cuda_kernels.normalize_plans`` drops is not stored."""
    from ..ops.cuda_kernels import plans_to_json
    good = plans_to_json(plans)
    if not good or not device:
        return
    sig = _streamed_sig(_sig_of(stages), in_dtype, platform)
    cur = _current(sig)
    tbl = {d: dict(b) for d, b in (cur.get("pallas_blocks") or {}).items()}
    tbl[str(device)] = good
    _record_axis(sig, "pallas_blocks", tbl)


def cached_pallas_blocks(stages, in_dtype, platform: str, device: str) -> Optional[dict]:
    """The plans a sweep recorded for this chain on this card; None when
    never swept there."""
    entry = cached_streamed_pick(stages, in_dtype, platform)
    if entry is None:
        return None
    plans = (entry.get("pallas_blocks") or {}).get(str(device))
    return dict(plans) if plans else None


def autotune_pallas_blocks(stages, in_dtype, inst: Optional[TpuInstance] = None,
                           kernels: Optional[Sequence[str]] = None, reps: int = 20,
                           force: bool = False, record: bool = True, shapes=None):
    """Run the kernel-plan sweep on this card and install its winners
    process-wide (``cuda_kernels.set_tuned_plans``), recorded under the
    chain's signature; a cache hit for this card skips the sweep and
    installs the recorded plans (``force=True`` measures again). Returns the
    installed table in its cache form; the sweep's full result, when one
    ran, is ``autotune_pallas_blocks.last_sweep``."""
    from ..ops.cuda_kernels import plans_to_json, set_tuned_plans
    from .kernel_tune import sweep_plans
    inst = inst or instance()
    dev = device_key(inst.device)
    plat = platform_of(inst)
    if not force:
        hit = cached_pallas_blocks(stages, in_dtype, plat, dev)
        if hit is not None:
            log.info("kernel-plan cache hit (%s): sweep skipped", dev)
            set_tuned_plans(hit)
            return hit
    res = sweep_plans(kernels=kernels, device=inst.device, reps=reps, shapes=shapes)
    autotune_pallas_blocks.last_sweep = res
    winners = plans_to_json(res["winners"])
    if record and winners:
        record_pallas_blocks(stages, in_dtype, plat, dev, winners)
    set_tuned_plans(winners)
    return winners


autotune_pallas_blocks.last_sweep = None


# ---------------------------------------------------------------------------
# the serving plane's axis: slot buckets and the page-pool pick
# ---------------------------------------------------------------------------

def record_serve_buckets(pipeline, in_dtype, platform: str, buckets: Sequence[int]) -> None:
    """Stamp a measured slot-bucket ladder on the chain's entry (beside its
    streamed picks: one signature, orthogonal planes)."""
    _record_axis(_streamed_sig(_sig_of(pipeline), in_dtype, platform), "serve_buckets",
                 sorted({int(b) for b in buckets if int(b) > 0}))


def cached_serve_buckets(pipeline, in_dtype, platform: str) -> Optional[list]:
    """The chain's cached slot-bucket ladder; None when never tuned."""
    entry = cached_streamed_pick(pipeline, in_dtype, platform)
    return None if entry is None else entry.get("serve_buckets")


def record_serve_pages(pipeline, in_dtype, platform: str, pages: int) -> None:
    """Stamp the page-pool capacity pick (the largest bucket the ladder
    kept): the engine starts its pool there, one build instead of a climb."""
    if int(pages) >= 1:
        _record_axis(_streamed_sig(_sig_of(pipeline), in_dtype, platform), "serve_pages",
                     int(pages))


def cached_serve_pages(pipeline, in_dtype, platform: str) -> Optional[int]:
    entry = cached_streamed_pick(pipeline, in_dtype, platform)
    return None if entry is None else entry.get("serve_pages")


def autotune_serve(pipeline, frame_size: Optional[int] = None,
                   inst: Optional[TpuInstance] = None,
                   capacities: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                   reps: int = 4, min_gain: float = 1.2,
                   record: bool = True) -> Tuple[list, Dict[int, float]]:
    """Measure the serving program a slot-bucket capacity and pick the
    ladder. Each capacity's real program (``serve/engine.build_slot_program``:
    the paged step the engine dispatches, one CUDA graph on a card) runs fully
    occupied, ``reps`` calls after a warm one; the rate is session-frames a
    second. The ladder keeps doubling while the rate still grows by
    ``min_gain`` a rung; past that a bigger bucket only adds latency and pad
    lanes. Returns ``(ladder, {capacity: session-frames/s})`` and records the
    ladder and its largest rung (the page-pool pick) under the chain's
    signature (``record=False``: measure only)."""
    from ..ops import xfer
    from ..ops.stages import _leaves
    from ..serve.engine import build_slot_program
    inst = inst or instance()
    dev = inst.device
    m = pipeline.frame_multiple
    fs = frame_size or inst.frame_size
    fs = max(m, (fs // m) * m)
    fresh = _leaves(pipeline.init_carry(dev))
    results: Dict[int, float] = {}
    ladder: list = []
    prev_rate = None
    for cap in sorted({int(c) for c in capacities if int(c) > 0}):
        prog = build_slot_program(pipeline, cap, 1, fs, dev)
        pages = [t.unsqueeze(0).repeat((cap,) + (1,) * t.dim()) for t in fresh]
        pmap = xfer.to_device(np.arange(cap, dtype=np.int64), dev)
        no_fresh = xfer.to_device(np.zeros(cap, dtype=bool), dev)
        x = xfer.to_device(np.zeros((cap, fs), dtype=pipeline.in_dtype), dev)
        act = xfer.to_device(np.ones(cap, dtype=bool), dev)
        pages, _outs = prog(pages, pmap, no_fresh, x, act)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            pages, _outs = prog(pages, pmap, no_fresh, x, act)
        _sync(dev)
        dt = max(time.perf_counter() - t0, 1e-9)
        rate = cap * reps / dt
        results[cap] = rate
        log.info("autotune_serve: capacity %d -> %.1f session-frames/s", cap, rate)
        if prev_rate is not None and rate < prev_rate * min_gain:
            break
        ladder.append(cap)
        prev_rate = rate
    if record and ladder:
        plat = platform_of(inst)
        record_serve_buckets(pipeline, pipeline.in_dtype, plat, ladder)
        record_serve_pages(pipeline, pipeline.in_dtype, plat, ladder[-1])
    return ladder, results


def record_shard_devices(stages, in_dtype, platform: str, n) -> None:
    """Stamp the measured best data-shard width on the chain's entry (the
    ``n_devices`` axis, beside its other picks); a width that is not a
    positive integer is dropped, not stored."""
    try:
        n = int(n)
    except (TypeError, ValueError):
        return
    if n >= 1:
        _record_axis(_streamed_sig(_sig_of(stages), in_dtype, platform), "n_devices", n)


def cached_shard_devices(stages, in_dtype, platform: str) -> Optional[int]:
    """The shard width the chain's last :func:`autotune_shard` picked; None
    when never stamped."""
    entry = cached_streamed_pick(stages, in_dtype, platform)
    return None if entry is None else entry.get("n_devices")


def autotune_shard(stages, in_dtype, frame: Optional[int] = None, k: int = 1,
                   devices: Sequence[int] = (1, 2, 4, 8), min_seconds: float = 0.3,
                   inst: Optional[TpuInstance] = None,
                   record: bool = True) -> Tuple[int, Dict[int, float]]:
    """Measure the data-sharded dispatch loop a width and pick the best.

    For each width D up to the devices there are (``parallel/mesh.
    visible_devices`` of the broker's device, config ``virtual_devices``
    included), one ``[D, k, frame]`` host group a call runs through what
    ``shard/data.ShardRunner`` dispatches (D = 1: the unsharded program at
    the same K), outputs gathered to the host, and the aggregate sample rate
    is measured. Returns ``(best_D, {D: Msamples/s})`` and records the pick
    under the chain's ``n_devices`` axis. A wider width is picked only when
    it measured strictly faster."""
    from ..parallel.mesh import visible_devices
    from ..shard.data import ShardedProgram, rows_to_host
    from ..shard.plan import plan_shard
    inst = inst or instance()
    dev = inst.device
    pipe = stages if isinstance(stages, Pipeline) else Pipeline(list(stages), in_dtype)
    m = pipe.frame_multiple
    f = frame or inst.frame_size
    f = max(m, (f // m) * m)
    avail = len(visible_devices(dev))
    results: Dict[int, float] = {}
    best, best_rate = 1, -1.0
    for D in sorted({int(d) for d in devices if 0 < int(d) <= avail}):
        try:
            host = np.zeros((D, k, f), dtype=pipe.in_dtype)
            if D == 1:
                fn1, carry = pipe.compile(f, dev, k=k)
                x1 = torch.from_numpy(host[0, 0] if k == 1 else host[0])

                def group(c, _fn=fn1, _x=x1):
                    c, y = _fn(c, _x.to(dev))
                    y.cpu()
                    return c
            else:
                prog = ShardedProgram(pipe, plan_shard(pipe, mode="data", n_devices=D,
                                                       device=dev), name=f"autotune_d{D}",
                                      device=dev)
                fnD, carry = prog.compile(f, k)
                xD = host[:, 0] if k == 1 else host

                def group(c, _fn=fnD, _x=xD):
                    c, ys = _fn(c, _x)
                    rows_to_host(ys)
                    return c
            carry = group(carry)                 # warm
            n = 0
            t0 = time.perf_counter()
            while True:
                carry = group(carry)
                n += D * k
                if time.perf_counter() - t0 > min_seconds or n > 10000:
                    break
            rate = n * f / (time.perf_counter() - t0) / 1e6
        except Exception as e:                 # noqa: BLE001 — OOM, short mesh, …
            log.warning("autotune_shard D=%d failed: %r", D, e)
            continue
        results[D] = rate
        if rate > best_rate:
            best_rate, best = rate, D
    log.info("autotune_shard best: D=%d (%.1f Msamples/s) over %s", best, best_rate, results)
    if record and results:
        record_shard_devices(pipe.stages, pipe.in_dtype, platform_of(inst), best)
    return best, results
