"""Interior precision: the SNR-budgeted lowering of a stage pipeline's interior.

The counterpart of ``futuresdr_tpu/ops/precision.py``. Two lowerings, per
stage:

* **Accumulation**: a stage that offers the ``Stage.lower`` hook
  (:func:`~futuresdr_tpu_torch.ops.stages.fir_stage`, ``fft_stage``,
  ``fir_fft_stage``, ``channelizer_stage`` and the polyphase decimator) is
  rebuilt at ``bf16`` or, where its hook accepts it, ``int8``. What that
  changes on a card: the hand kernels' bf16 mode rounds their operands to
  bf16 inside the kernel (they still read float32 from memory), the
  polyphase weights and the PFB taps are carried in bf16 (half their
  bytes), the int8 rungs quantize both operands on the device and take
  int8 × int8 products. The overlap-save FIR's and ``fft_stage``'s bf16 rung
  stays a float32 ``torch.fft`` on every device (there is no bf16 FFT), as
  the JAX package's matmul-precision flag is exact off the TPU: it measures
  SNR ∞ in both packages, so they make the same plan.
* **Interior edge**: any float edge between stages (never a sink: the
  boundary wire is ``ops/wire.py``'s) is rounded through bfloat16, a complex
  edge a plane at a time.

Calibration (``mode="auto"``): seeded Gaussian frames run the float32
program stage by stage on the kernel's device, eagerly, before anything is
captured; each candidate lowering is replayed on the reference inputs at its
own edge and its SNR against the reference output is measured. A lowering
under ``interior_snr_budget_db`` is refused, with the reason recorded. The
lowered composition's sink SNR must then clear ``budget − 10·log10(n)`` (n
the lowered stages, the incoherent-sum allowance) or the whole plan is
declined. ``mode="bf16"`` lowers every supporting stage and edge to bf16
whatever it measures; ``mode="int8"`` as deep as each hook goes (int8, else
bf16). ``mode="off"`` returns the pipeline object itself.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["EdgeDecision", "PrecisionPlan", "plan_interior_precision",
           "lower_pipeline", "snr_db", "parse_overrides", "note_plan",
           "plans_report", "clear_plans", "pallas_stage_count",
           "dominant_compute_dtype", "MODES"]

#: precisions tried a stage, most compressed first (int8 only where the
#: stage's hook accepts it)
LOWER_LADDER = ("int8", "bf16")
MODES = ("off", "auto", "bf16", "int8")


def snr_db(ref, got) -> float:
    """SNR of ``got`` against ``ref`` in dB (inf when equal)."""
    ref = _host(ref).astype(np.complex128)
    got = _host(got).astype(np.complex128)
    err = float(np.mean(np.abs(got - ref) ** 2))
    sig = float(np.mean(np.abs(ref) ** 2))
    if err == 0.0:
        return float("inf")
    if sig == 0.0:
        return float("-inf")
    return 10.0 * float(np.log10(sig / err))


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _edge_cast(y: torch.Tensor) -> torch.Tensor:
    """One interior edge rounded through bfloat16 (complex: a plane at a
    time), in the stream's dtype; integer edges pass through."""
    if y.is_complex():
        return torch.complex(_bf16_round(y.real), _bf16_round(y.imag)).to(y.dtype)
    if y.is_floating_point():
        return _bf16_round(y)
    return y


@dataclass
class EdgeDecision:
    """One stage's verdict: the accumulation and output-edge precisions
    applied, the SNRs measured for them, and, only where nothing was
    lowered, the refusal's reason."""
    stage: str
    node: int
    index: int                    # flat stage index (update_stage addressing)
    accum: str = "f32"            # "f32" | "bf16" | "int8"
    edge: str = "f32"             # "f32" | "bf16"
    accum_snr_db: Optional[float] = None
    edge_snr_db: Optional[float] = None
    declined: Optional[str] = None

    def as_dict(self) -> dict:
        def _r(v):
            if v is None:
                return None
            return round(v, 1) if np.isfinite(v) else None
        return {"stage": self.stage, "node": self.node, "index": self.index,
                "accum": self.accum, "edge": self.edge,
                "accum_snr_db": _r(self.accum_snr_db),
                "edge_snr_db": _r(self.edge_snr_db),
                "declined": self.declined}


@dataclass
class PrecisionPlan:
    mode: str
    budget_db: float
    edges: List[EdgeDecision] = field(default_factory=list)
    e2e_snr_db: Optional[float] = None     # min across sinks, lowered vs f32
    declined_e2e: bool = False             # an auto plan rolled back whole
    frame: int = 0                         # calibration frame size

    @property
    def lowered(self) -> int:
        """Stages with any lowering (accumulation or edge)."""
        return sum(1 for e in self.edges if e.accum != "f32" or e.edge != "f32")

    @property
    def min_snr_db(self) -> Optional[float]:
        """The worst finite SNR among the accepted lowerings and the
        end-to-end one; None when nothing lowered or all were exact."""
        vals = []
        for e in self.edges:
            if e.accum != "f32" and e.accum_snr_db is not None \
                    and np.isfinite(e.accum_snr_db):
                vals.append(e.accum_snr_db)
            if e.edge != "f32" and e.edge_snr_db is not None \
                    and np.isfinite(e.edge_snr_db):
                vals.append(e.edge_snr_db)
        if self.e2e_snr_db is not None and np.isfinite(self.e2e_snr_db) and self.lowered:
            vals.append(self.e2e_snr_db)
        return min(vals) if vals else None

    def as_dict(self) -> dict:
        mn, e2e = self.min_snr_db, self.e2e_snr_db
        return {"mode": self.mode, "budget_db": self.budget_db,
                "lowered": self.lowered,
                "declined": sum(1 for e in self.edges if e.declined),
                "min_snr_db": round(mn, 1) if mn is not None else None,
                "e2e_snr_db": (round(e2e, 1)
                               if e2e is not None and np.isfinite(e2e) else None),
                "declined_e2e": self.declined_e2e,
                "frame": self.frame,
                "edges": [e.as_dict() for e in self.edges]}


def parse_overrides(spec) -> Dict[str, str]:
    """``"fir=off;fft2048=bf16"`` or a dict → ``{stage name: mode}``; an
    unknown mode raises."""
    if not spec:
        return {}
    items = spec.items() if isinstance(spec, dict) else \
        (part.split("=", 1) for part in str(spec).split(";") if part)
    out = {}
    for k, v in items:
        v = str(v).strip()
        if v not in MODES:
            raise ValueError(f"interior_precision override {k!r}={v!r}: "
                             f"expected off|auto|bf16|int8")
        out[str(k).strip()] = v
    return out


# ---------------------------------------------------------------------------
# one node view over the three pipeline classes
# ---------------------------------------------------------------------------

def _as_nodes(pipeline) -> Tuple[list, str]:
    """``([(stages, input ids)], kind)`` in topological order, the stages as
    ``update_stage`` sees them (after LTI merging)."""
    from .stages import DagPipeline, FanoutPipeline
    if isinstance(pipeline, DagPipeline):
        return [(list(sl), list(inputs)) for sl, inputs, _off in pipeline._nodes], "dag"
    if isinstance(pipeline, FanoutPipeline):
        nodes = [(list(pipeline.producer.stages), [])]
        nodes += [(list(b.stages), [0]) for b in pipeline.branches]
        return nodes, "fanout"
    return [(list(pipeline.stages), [])], "linear"


def _rebuild(pipeline, kind: str, new_nodes: list):
    from .stages import DagPipeline, FanoutPipeline, Pipeline
    if kind == "dag":
        return DagPipeline([(sl, inputs) for sl, inputs in new_nodes],
                           pipeline.in_dtype, optimize=False)
    if kind == "fanout":
        return FanoutPipeline(new_nodes[0][0], [sl for sl, _in in new_nodes[1:]],
                              pipeline.in_dtype, optimize=False)
    return Pipeline(new_nodes[0][0], pipeline.in_dtype, optimize=False)


def _sink_nodes(nodes: list) -> set:
    consumed = set()
    for _sl, inputs in nodes:
        consumed.update(inputs)
    return {i for i in range(len(nodes)) if i not in consumed}


def _calib_frames(in_dtype, frame: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if np.issubdtype(np.dtype(in_dtype), np.complexfloating):
            f = ((rng.standard_normal(frame) + 1j * rng.standard_normal(frame))
                 / np.sqrt(2)).astype(in_dtype)
        elif np.issubdtype(np.dtype(in_dtype), np.floating):
            f = rng.standard_normal(frame).astype(in_dtype)
        else:
            f = rng.integers(0, 127, frame).astype(in_dtype)
        out.append(f)
    return out


def _dtype_of(v) -> np.dtype:
    if isinstance(v, tuple):
        v = v[0]
    if isinstance(v, torch.Tensor):
        return torch.empty(0, dtype=v.dtype).numpy().dtype
    return np.dtype(getattr(v, "dtype", np.float32))


def _run_graph(nodes: list, frames: list, device, io_ins: Optional[dict] = None,
               io_out: Optional[dict] = None) -> list:
    """Run the node graph eagerly over the calibration frames on ``device``,
    the carry chained frame to frame; returns each sink's output of the last
    frame. ``io_ins`` collects each (node, stage)'s inputs of every frame (the
    candidates' replay feed), ``io_out`` its output of the last frame."""
    carries: Dict[tuple, Any] = {}
    sinks = sorted(_sink_nodes(nodes))
    last_out = None
    for fi, x in enumerate(frames):
        vals: list = [None] * len(nodes)
        for ni, (stages, inputs) in enumerate(nodes):
            if not inputs:
                v = torch.from_numpy(x).to(device)
            elif len(inputs) == 1:
                v = vals[inputs[0]]
            else:
                v = tuple(vals[j] for j in inputs)
            for si, s in enumerate(stages):
                key = (ni, si)
                if key not in carries:
                    carries[key] = s.init_carry(_dtype_of(v), device)
                if io_ins is not None:
                    io_ins.setdefault(key, []).append(v)
                c, v = s.fn(carries[key], v)
                carries[key] = c
                if io_out is not None and fi == len(frames) - 1:
                    io_out[key] = v
            vals[ni] = v
        last_out = [vals[s] for s in sinks]
    return last_out


def _replay_stage(stage, ref_in_frames: list, device) -> Any:
    """A candidate stage over the reference inputs at its edge (fresh carry,
    chained across the frames); its output of the last frame."""
    c = stage.init_carry(_dtype_of(ref_in_frames[0]), device)
    y = None
    for v in ref_in_frames:
        c, y = stage.fn(c, v)
    return y


def _wrap_edge(s):
    """The (maybe accumulation-lowered) stage with its output edge rounded
    through bf16. ``lti`` goes: a merge would drop the wrapper."""
    inner = s.fn

    def fn(carry, x):
        carry, y = inner(carry, x)
        return carry, _edge_cast(y)

    return replace(s, fn=fn, lti=None)


def _is_float_val(v) -> bool:
    dt = _dtype_of(v)
    return bool(np.issubdtype(dt, np.floating) or np.issubdtype(dt, np.complexfloating))


def _edge_cast_host(y) -> np.ndarray:
    """:func:`_edge_cast` of a value, on the CPU, as numpy (numpy has no
    bfloat16: torch rounds it)."""
    t = y.detach().cpu() if isinstance(y, torch.Tensor) else torch.from_numpy(np.asarray(y))
    return _edge_cast(t).numpy()


def plan_interior_precision(pipeline, mode: Optional[str] = None,
                            budget_db: Optional[float] = None, overrides=None,
                            frame: Optional[int] = None, seed: int = 0, device=None):
    """Plan and build the interior-precision-lowered form of ``pipeline``
    (a ``Pipeline``, ``FanoutPipeline`` or ``DagPipeline``); returns
    ``(lowered, plan)``. ``mode``, ``budget_db`` and ``overrides`` (a dict or
    ``"stage=off;…"``, pinning per-stage verdicts) default to config
    ``interior_precision``, ``interior_snr_budget_db`` and
    ``interior_precision_overrides``. ``mode="off"`` returns ``pipeline``
    itself. Calibration runs on ``device`` (default: the process's card,
    ``tpu/instance.py``; pass ``"cpu"`` for the CPU)."""
    from ..config import config
    c = config()
    if mode is None:
        mode = str(c.interior_precision or "off")
    if mode in ("", "off", "0", "false", "none"):
        return pipeline, PrecisionPlan("off", 0.0)
    if mode not in MODES:
        raise ValueError(f"interior_precision mode {mode!r}: expected one of {MODES}")
    if budget_db is None:
        budget_db = float(c.interior_snr_budget_db)
    if overrides is None:
        overrides = c.interior_precision_overrides
    overrides = parse_overrides(overrides)
    if device is None:
        from ..tpu.instance import instance
        device = instance().device
    device = torch.device(device)

    nodes, kind = _as_nodes(pipeline)
    fm = int(pipeline.frame_multiple)
    if frame is None:
        frame = fm * max(1, -(-8192 // fm))
    else:
        frame = max(fm, (int(frame) // fm) * fm)
    frames = _calib_frames(pipeline.in_dtype, frame, 2, seed)

    io_all: Dict[tuple, list] = {}
    io_out: Dict[tuple, Any] = {}
    with torch.no_grad():
        ref_sinks = _run_graph(nodes, frames, device, io_ins=io_all, io_out=io_out)
        plan, new_nodes = _plan_nodes(nodes, io_all, io_out, str(mode),
                                      float(budget_db), overrides, frame, device)
        if plan.lowered == 0:
            return pipeline, plan
        lowered = _rebuild(pipeline, kind, new_nodes)
        # the end-to-end guard: the composition must clear the budget less the
        # incoherent-sum allowance of the accepted lowerings
        low_sinks = _run_graph(_as_nodes(lowered)[0], frames, device)
    e2e = min(snr_db(r, g) for r, g in zip(ref_sinks, low_sinks))
    plan.e2e_snr_db = e2e
    if mode == "auto":
        floor = budget_db - 10.0 * np.log10(max(1, plan.lowered))
        if e2e < floor:
            plan.declined_e2e = True
            for d in plan.edges:
                if d.accum != "f32" or d.edge != "f32":
                    d.accum = d.edge = "f32"
                    d.declined = f"e2e-snr<{floor:.1f}dB"
            return pipeline, plan
    return lowered, plan


def _plan_nodes(nodes, io_all, io_out, mode: str, budget_db: float, overrides: dict,
                frame: int, device) -> Tuple[PrecisionPlan, list]:
    """Each stage's verdict against the float32 trace; the plan and the
    lowered node list."""
    from .stages import MergeStage
    sinks = _sink_nodes(nodes)
    plan = PrecisionPlan(mode, budget_db, frame=frame)
    forced = mode in ("bf16", "int8")
    new_nodes: list = []
    flat = 0
    for ni, (stages, inputs) in enumerate(nodes):
        new_stages: list = []
        for si, s in enumerate(stages):
            d = EdgeDecision(stage=str(getattr(s, "name", "?")), node=ni, index=flat)
            flat += 1
            cur = s
            ref_out = io_out[(ni, si)]
            ov = overrides.get(d.stage)
            is_boundary = si == len(stages) - 1 and ni in sinks
            if isinstance(s, MergeStage):
                d.declined = "merge"
            elif ov == "off":
                d.declined = "override"
            elif not _is_float_val(ref_out):
                d.declined = "non-float"
            else:
                # -- the accumulation ladder (where the stage has a hook) --
                if s.lower is not None:
                    if ov in ("bf16", "int8"):
                        ladder = (ov,)
                    elif mode == "bf16":
                        ladder = ("bf16",)      # forced bf16 takes no deeper rung
                    else:
                        ladder = LOWER_LADDER
                    for prec in ladder:
                        cand = s.lower(prec)
                        if cand is None:
                            if ov == prec:
                                d.declined = f"unsupported:{prec}"
                            continue
                        s_db = snr_db(ref_out, _replay_stage(cand, io_all[(ni, si)],
                                                             device))
                        d.accum_snr_db = s_db
                        if forced or s_db >= budget_db or ov == prec:
                            d.accum = prec
                            cur = cand
                            d.declined = None
                            break
                        d.declined = f"accum-snr<{budget_db:g}dB"
                elif ov in ("bf16", "int8"):
                    d.declined = "no-lower-hook"
                # -- the interior edge (never a sink) --
                if not is_boundary:
                    e_db = snr_db(ref_out, _edge_cast_host(ref_out))
                    d.edge_snr_db = e_db
                    if forced or e_db >= budget_db:
                        d.edge = "bf16"
                        cur = _wrap_edge(cur)
                        d.declined = None
                    elif d.accum == "f32" and d.declined is None:
                        d.declined = f"edge-snr<{budget_db:g}dB"
            plan.edges.append(d)
            new_stages.append(cur)
        new_nodes.append((new_stages, list(inputs)))
    return plan, new_nodes


#: most callers want the (pipeline, plan) pair
lower_pipeline = plan_interior_precision


# ---------------------------------------------------------------------------
# the plans applied, by program name
# ---------------------------------------------------------------------------

_plans_lock = threading.Lock()
_plans: Dict[str, dict] = {}


def note_plan(program: str, plan: PrecisionPlan) -> None:
    """Publish a kernel's applied plan under its program (instance) name."""
    with _plans_lock:
        _plans[str(program)] = plan.as_dict()


def plans_report() -> Dict[str, dict]:
    """Every published plan, JSON-clean."""
    with _plans_lock:
        return {k: dict(v) for k, v in _plans.items()}


def clear_plans() -> None:
    with _plans_lock:
        _plans.clear()


def dominant_compute_dtype(pipeline) -> str:
    """``"int8"`` when any stage accumulates in int8, else ``"bf16"`` when
    any does in bf16, else ``"f32"`` (``utils/roofline.dominant_dtype``)."""
    from ..utils.roofline import dominant_dtype
    return dominant_dtype(getattr(pipeline, "stages", []))


def pallas_stage_count(pipeline, device=None) -> int:
    """How many stages of ``pipeline`` run one of the port's hand-written
    CUDA kernels (the name is the JAX package's, whose kernels are Pallas),
    from each stage's route: a forced ``impl="pallas"`` (a ``fir_fft`` stage
    is one), and an ``"auto"`` channelizer where ``device`` is a card
    (default: a card when one is present), where its policy takes the
    kernel; the int8 rung computes through int8 products, never a kernel."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_card = torch.device(device).type == "cuda"
    n = 0
    for s in getattr(pipeline, "stages", []):
        name = str(getattr(s, "name", ""))
        route = getattr(s, "route", None)
        if route is None:
            continue
        if len(route) > 2 and route[2] == "int8":
            continue
        lti = getattr(s, "lti", None)
        if lti is not None:
            taps, _decim, _fl, lti_impl = lti
            eff = route[0] or lti_impl
            if eff == "pallas" and np.isrealobj(taps) and np.asarray(taps).size >= 2:
                n += 1
        elif "channelizer" in name:
            if route[0] == "pallas" or (route[0] == "auto" and on_card):
                n += 1
        elif route[0] == "pallas":
            n += 1
    return n
