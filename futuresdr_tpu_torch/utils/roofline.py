"""Roofline accounting for stage pipelines: analytic bytes and operations.

The counterpart of ``futuresdr_tpu/utils/roofline.py``, which reads XLA's
cost analysis of the compiled program. A CUDA graph has no cost analysis,
so here each stage declares what it must move and compute for ``n`` input
items (``Stage.cost``; :func:`kernel_cost` for the hand kernels, the same
counts ``chip_smoke.py`` divides by and PERF.md's Bound column holds): each
input read once, each output written once, the carried parameters read once,
the operations the arithmetic needs (a complex MAC 4, a real one 2, an
N-point FFT ``5·N·log2 N``). A stage without a declaration counts its input
and output bytes and one operation an input item. :func:`program_cost`,
:func:`pipeline_roofline` and :func:`graph_roofline` sum them per dispatch,
per stage and per node (fan-out branches, DAG nodes).

Peaks (:func:`detect_peaks`): the live card's name against
:data:`CHIP_PEAKS`, the published figures of the one card the port runs on;
an unknown card and the CPU give None (bytes and operations only, never a
share against the wrong peak).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["CHIP_PEAKS", "detect_peaks", "dtype_peak_flops", "dominant_dtype",
           "kernel_cost", "stage_cost", "cost_of", "program_cost", "pipeline_roofline",
           "graph_roofline"]

#: published peaks, dense, per card. "NVIDIA H100 80GB HBM3" (H100 SXM, the
#: data sheet): HBM3 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores
#: (the hand kernels' FMA path); 989 TFLOP/s bf16 and 1,979 TOP/s int8 on the
#: tensor cores. At the full 700 W power limit.
CHIP_PEAKS = {
    "h100": {"flops": 989e12, "f32_flops": 67e12, "int8_flops": 1979e12,
             "hbm_bytes": 3.35e12},
}


def _kind_to_chip(kind: str) -> Optional[str]:
    """A card name (``torch.cuda.get_device_name``) → a :data:`CHIP_PEAKS`
    key, None when unknown."""
    return "h100" if "h100" in str(kind).lower() else None


def dtype_peak_flops(peaks: dict, dtype: Optional[str] = None) -> float:
    """The operations peak for a program whose dominant compute type is
    ``dtype``: ``"bf16"`` the tensor cores' bf16 rate, ``"int8"`` their int8
    rate, ``"f32"`` (and None) the float32 FMA rate (the card publishes one;
    the JAX package halves its bf16 figure for a TPU, which has none)."""
    d = str(dtype or "f32")
    if d == "bf16":
        return float(peaks["flops"])
    if d == "int8":
        return float(peaks.get("int8_flops", peaks["flops"]))
    return float(peaks.get("f32_flops", peaks["flops"]))


def dominant_dtype(stages) -> str:
    """``"int8"`` when any stage accumulates in int8, else ``"bf16"`` when
    any does in bf16, else ``"f32"``."""
    bf16 = False
    for s in stages:
        cd = getattr(s, "compute_dtype", "f32")
        if cd == "int8":
            return "int8"
        bf16 = bf16 or cd == "bf16"
    return "bf16" if bf16 else "f32"


def detect_peaks(device=None, dtype: Optional[str] = None,
                 chip: Optional[str] = None) -> Optional[dict]:
    """``{"flops", "hbm_bytes", "chip"}`` of ``device`` (default: the card
    when one is present), or of the named ``chip`` (a card name, for
    accounting away from the card); ``flops`` keyed on ``dtype``
    (:func:`dtype_peak_flops`). None on the CPU or an unknown card."""
    if chip is None:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type != "cuda":
            return None
        chip = torch.cuda.get_device_name(device)
    key = _kind_to_chip(chip)
    if key is None:
        return None
    p = CHIP_PEAKS[key]
    return {"flops": dtype_peak_flops(p, dtype), "hbm_bytes": p["hbm_bytes"],
            "chip": key, "dtype": str(dtype or "f32")}


def _elt(dtype) -> int:
    return int(np.dtype(dtype).itemsize)


def _log2(n: int) -> float:
    return float(np.log2(max(int(n), 1)))


def kernel_cost(kernel: str, **s) -> Tuple[float, float]:
    """``(bytes, operations)`` of one call of a hand kernel (the counts of
    PERF.md's Bound column):

    * ``fir(n, nt, complex=True)``: stream and history in, taps, output out;
      a real MAC (2 operations) a tap, a plane, a sample;
    * ``fir_fft(n, nt, n_fft, complex=True)``: ``fir``'s, the twiddles, and
      the FFT's ``5·log2 n_fft`` a sample;
    * ``rotator(n)``, ``quad_demod(n)``: complex64 in, out, their scalars;
    * ``poly_fir(n, m, D, I=1, complex=True, w_bytes=4)``: the input with its
      ``m·D`` history, ``W``, ``n/D·I`` outputs, a MAC a weight an output;
    * ``pfb(n, N, K, tap_bytes=4)``: history, frame in and out, taps,
      twiddles; ``4K + 5·log2 N`` a sample;
    * ``pfb_lanes(L, n, N, K, tap_bytes=4, shared=False)``: ``L`` times
      ``pfb``'s on each lane's ``n`` samples, with the twiddle table, one for
      every lane, read once, and a ``shared`` prototype's taps read once;
    * ``viterbi(B, T, S=64, steps=B·T)``: the LLRs of the ``steps`` real
      steps (8 bytes a frame a step) and the frame lengths in, the four
      trellis tables in, the decoded bits (one byte a step of the ``[B, T]``
      output) out; a state's two candidates (two products and two sums each)
      and their compare, 9 operations a state a real step. The steps of a
      frame, and of its traceback, run one after another, so the card's
      floor is set by their latency, not by these.
    """
    if kernel == "fir":
        n, nt, e = s["n"], s["nt"], 8 if s.get("complex", True) else 4
        return float((n + nt - 1) * e + nt * 4 + n * e), float(e // 2 * nt * n)
    if kernel == "fir_fft":
        n, nt, nf = s["n"], s["nt"], s["n_fft"]
        e = 8 if s.get("complex", True) else 4
        return (float((n + nt - 1) * e + nt * 4 + n * 8 + nf * 8),
                float(n * (e // 2 * nt + 5 * int(_log2(nf)))))
    if kernel == "rotator":
        n = s["n"]
        return float(16 * n + 8), float(8 * n)
    if kernel == "quad_demod":
        n = s["n"]
        return float(12 * n + 16), float(7 * n)
    if kernel == "poly_fir":
        n, m, D, I = s["n"], s["m"], s["D"], s.get("I", 1)
        e = 8 if s.get("complex", True) else 4
        w = (m + 1) * D * I
        nq = n // D
        return (float(e * (n + m * D) + s.get("w_bytes", 4) * w + e * nq * I),
                float(e // 2 * w * nq))
    if kernel == "pfb":
        n, N, K = s["n"], s["N"], s["K"]
        return (float(8 * (K - 1) * N + 16 * n + s.get("tap_bytes", 4) * K * N + 8 * N),
                float(n * (4 * K + 5 * int(_log2(N)))))
    if kernel == "pfb_lanes":
        L, N, K = s["L"], s["N"], s["K"]
        nbytes, ops = kernel_cost("pfb", n=s["n"], N=N, K=K, tap_bytes=s.get("tap_bytes", 4))
        once = 8 * N + (s.get("tap_bytes", 4) * K * N if s.get("shared") else 0)
        return float(L * nbytes - (L - 1) * once), float(L * ops)
    if kernel == "viterbi":
        B, T, S = s["B"], s["T"], s.get("S", 64)
        n = s.get("steps", B * T)
        return float(8 * n + 4 * B + 16 * 2 * S + B * T), float(9 * S * n)
    raise ValueError(f"unknown kernel {kernel!r}")


def stage_cost(stage, n: int, in_dtype) -> Tuple[float, float]:
    """``(bytes, operations)`` of ``stage`` on ``n`` input items of
    ``in_dtype``: its ``cost`` declaration, else its input and output bytes
    and one operation an item (a merge: ``n`` items an input)."""
    cost = getattr(stage, "cost", None)
    if cost is not None:
        return tuple(float(v) for v in cost(int(n), np.dtype(in_dtype)))
    out_dt = np.dtype(stage.out_dtype) if stage.out_dtype is not None else np.dtype(in_dtype)
    k = getattr(stage, "k", 1) if getattr(stage, "mode", None) == "equal" else 1
    n_out = int(n * stage.ratio)
    return float(n * k * _elt(in_dtype) + n_out * _elt(out_dt)), float(n * k)


# ---------------------------------------------------------------------------
# per-dispatch and per-stage sums
# ---------------------------------------------------------------------------

#: ``signature -> {"flops", "bytes"}``, one count a signature a process
_cost_cache: Dict[tuple, dict] = {}


def cost_of(pipeline, frame: int = 0, signature: Optional[tuple] = None) -> dict:
    """``{"flops", "bytes"}`` of one ``frame`` through ``pipeline``'s
    stages (linear, fan-out or DAG), cached by ``signature`` (a hit reads
    nothing of ``pipeline``)."""
    if signature is not None:
        hit = _cost_cache.get(signature)
        if hit is not None:
            return dict(hit)
    out = {"flops": 0.0, "bytes": 0.0}
    for _name, _inputs, b, f in _node_costs(pipeline, frame):
        out["bytes"] += b
        out["flops"] += f
    if signature is not None:
        _cost_cache[signature] = dict(out)
    return out


def _stage_marker(s) -> tuple:
    """A stage's structural fingerprint for cost-cache keys: its name, rate,
    dtype, frame multiple, LTI shape, route and merge shape."""
    lti = getattr(s, "lti", None)
    lti_m = None
    if lti is not None:
        taps, decim, fft_len, impl = lti
        lti_m = (int(np.asarray(taps).size), int(decim), int(fft_len), str(impl))
    return (str(getattr(s, "name", "?")), str(getattr(s, "ratio", "")),
            str(getattr(s, "out_dtype", None)), int(getattr(s, "frame_multiple", 1) or 1),
            lti_m, getattr(s, "route", None), getattr(s, "k", None),
            getattr(s, "mode", None), getattr(s, "compute_dtype", None))


def _nodes_of(pipeline) -> list:
    from ..ops.stages import DagPipeline, FanoutPipeline
    if isinstance(pipeline, DagPipeline):
        return [(list(sl), list(inputs)) for sl, inputs, _off in pipeline._nodes]
    if isinstance(pipeline, FanoutPipeline):
        return [(list(pipeline.producer.stages), [])] + \
            [(list(b.stages), [0]) for b in pipeline.branches]
    return [(list(pipeline.stages), [])]


def _node_costs(pipeline, frame: int) -> list:
    """``[(name, inputs, bytes, flops)]`` a node of ``pipeline`` for one
    frame, each stage charged at its own input size."""
    nodes = _nodes_of(pipeline)
    sizes: list = []
    dts: list = []
    out = []
    for sl, inputs in nodes:
        if not inputs:
            n, dt = int(frame), np.dtype(pipeline.in_dtype)
        else:
            n, dt = sizes[inputs[0]], dts[inputs[0]]
        b = f = 0.0
        for si, s in enumerate(sl):
            if si == 0 and len(inputs) > 1 and getattr(s, "mode", None) == "concat":
                n = sum(sizes[j] for j in inputs)
            sb, sf = stage_cost(s, n, dt)
            b, f = b + sb, f + sf
            n = int(n * s.ratio)
            if s.out_dtype is not None:
                dt = np.dtype(s.out_dtype)
        sizes.append(n)
        dts.append(dt)
        name = "+".join(str(getattr(s, "name", "?")) for s in sl) or "passthrough"
        out.append((name, list(inputs), b, f))
    return out


def program_cost(pipeline, frame: int, wire=None, k: int = 1) -> dict:
    """``{"flops", "bytes"}`` of one dispatch of ``pipeline``'s program:
    ``k`` frames; with a ``wire`` (``ops/wire.py``) also its decode and
    encode inside the program (the encoded parts read and written, two
    operations an item each way). Cached by the pipeline's signature."""
    from ..ops.wire import get_wire
    markers = tuple(_stage_marker(s) for s in pipeline.stages)
    topo = tuple((len(sl), tuple(inputs)) for sl, inputs in _nodes_of(pipeline))
    wname = None if wire is None else get_wire(wire).name
    sig = ("program", type(pipeline).__name__, str(np.dtype(pipeline.in_dtype)),
           int(frame), wname, int(k), markers, topo)
    hit = _cost_cache.get(sig)
    if hit is not None:
        return dict(hit)
    c = cost_of(pipeline, frame)
    if wire is not None:
        w = get_wire(wire)
        in_b = sum(np.asarray(p).nbytes for p in w.encode_host(
            np.zeros(frame, dtype=pipeline.in_dtype)))
        outs = getattr(pipeline, "out_dtypes", None) or [pipeline.out_dtype]
        ratios = getattr(pipeline, "path_ratios", None) or [pipeline.ratio]
        out_b = 0
        for dt, r in zip(outs, ratios):
            n_out = int(frame * r)
            out_b += sum(np.asarray(p).nbytes for p in w.encode_host(np.zeros(n_out, dt)))
            c["flops"] += 2 * n_out
        c["bytes"] += in_b + out_b
        c["flops"] += 2 * frame
    out = {"flops": c["flops"] * k, "bytes": c["bytes"] * k}
    _cost_cache[sig] = dict(out)
    return out


def pipeline_roofline(stages: Sequence, in_dtype, frame: int,
                      rate_sps: Optional[float] = None, device=None,
                      chip: Optional[str] = None) -> dict:
    """Operations and bytes a sample for the chain and each stage (each at
    its own input rate, per chain-input sample); with ``rate_sps`` the
    achieved FLOP/s and bytes/s and, where the card's peaks are known
    (:func:`detect_peaks`), their shares of the peaks and each stage's
    bound (memory or compute, by its arithmetic intensity against the
    ridge)."""
    from ..ops.stages import Pipeline
    pipe = Pipeline(list(stages), in_dtype, optimize=False)
    out = {"frame": frame, "stages": []}
    n, dt = int(frame), np.dtype(in_dtype)
    for s in pipe.stages:
        b, f = stage_cost(s, n, dt)
        out["stages"].append({"name": s.name, "flops_per_sample": f / frame,
                              "bytes_per_sample": b / frame})
        n = int(n * s.ratio)
        if s.out_dtype is not None:
            dt = np.dtype(s.out_dtype)
    out["flops_per_sample"] = sum(s["flops_per_sample"] for s in out["stages"])
    out["bytes_per_sample"] = sum(s["bytes_per_sample"] for s in out["stages"])
    _finish(out, out["stages"], rate_sps, device, chip, dominant_dtype(pipe.stages))
    return out


def graph_roofline(pipeline, frame: Optional[int] = None,
                   rate_sps: Optional[float] = None, device=None,
                   chip: Optional[str] = None) -> dict:
    """:func:`pipeline_roofline` a node of a ``FanoutPipeline`` (producer,
    then a node a branch) or ``DagPipeline``; a ``Pipeline`` gives its
    stages under ``nodes``. Per sample of the region's input."""
    from ..ops.stages import DagPipeline, FanoutPipeline, Pipeline
    if isinstance(pipeline, Pipeline):
        out = pipeline_roofline(pipeline.stages, pipeline.in_dtype,
                                frame or pipeline.frame_multiple, rate_sps, device, chip)
        out["nodes"] = [dict(s, inputs=([] if i == 0 else [i - 1]))
                        for i, s in enumerate(out["stages"])]
        return out
    if not isinstance(pipeline, (FanoutPipeline, DagPipeline)):
        raise TypeError(f"graph_roofline: unsupported pipeline type "
                        f"{type(pipeline).__name__}")
    fm = pipeline.frame_multiple
    frame = max(fm, (int(frame or fm) // fm) * fm)
    out = {"frame": frame, "nodes": []}
    for name, inputs, b, f in _node_costs(pipeline, frame):
        out["nodes"].append({"name": name, "inputs": inputs,
                             "flops_per_sample": f / frame,
                             "bytes_per_sample": b / frame})
    out["flops_per_sample"] = sum(x["flops_per_sample"] for x in out["nodes"])
    out["bytes_per_sample"] = sum(x["bytes_per_sample"] for x in out["nodes"])
    _finish(out, out["nodes"], rate_sps, device, chip, dominant_dtype(pipeline.stages))
    return out


def _finish(out: dict, entries, rate_sps, device, chip, dtype: str) -> None:
    """The shared tail: bound classes against the ridge, achieved rates and
    their shares of the peaks."""
    peak = detect_peaks(device, dtype=dtype, chip=chip)
    out["compute_dtype"] = dtype
    if peak:
        ridge = peak["flops"] / peak["hbm_bytes"]
        for s in entries:
            ai = s["flops_per_sample"] / max(s["bytes_per_sample"], 1e-12)
            s["arith_intensity"] = ai
            s["bound"] = "hbm" if ai < ridge else "compute"
    if rate_sps:
        out["achieved_flops"] = rate_sps * out["flops_per_sample"]
        out["achieved_bw_bytes"] = rate_sps * out["bytes_per_sample"]
        if peak:
            out["mfu"] = out["achieved_flops"] / peak["flops"]
            out["hbm_util"] = out["achieved_bw_bytes"] / peak["hbm_bytes"]
