"""Shard-plan pass: decide how a fused device program spreads over a mesh.

The counterpart of ``futuresdr_tpu/shard/plan.py``. One pass inspects a fused
``Pipeline``/``FanoutPipeline``/``DagPipeline`` and decides, stage by stage,
how it rides a one-axis :class:`~futuresdr_tpu_torch.parallel.mesh.Mesh`; the
decisions and every decline, with its reason, are published
(:func:`note_plan`, :func:`plans_report`). Modes (config ``shard`` or
``mode=``):

* ``off``: the default and the single-device contract; ``n_devices == 1``
  resolves to it too. ``shard/data.shard_pipeline`` then returns the same
  pipeline object.
* ``data``: D independent stream lanes, one carry and one CUDA graph a device
  (``shard/data.ShardedProgram``); no stage communicates across shards and
  each device's row equals the D = 1 program fed that row, bit for bit.
* ``model``: one frame's item axis split into D contiguous spans
  (``shard/model.ModelShardedProgram``). A stage whose carry is an
  input-history window (``Stage.history``: the FIR, ``fir_fft``, the PFB)
  takes the previous span's tail as its carry; a stateless stage (the FFT,
  ``|x|²``) needs nothing. A stage with any other carry cannot split without
  running the spans one after another: it is recorded as ``replicate`` and
  the plan falls back to ``data``, a decline with its reason. (The
  reference lets GSPMD replicate such a stage and keeps ``model``.)

``auto`` resolves to ``data``. Refusals are loud: an unknown mode, or more
devices than exist, raise ``ValueError`` (the ``make_mesh`` contract).
Declines with a sound fallback are recorded on the plan.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["StageDecision", "ShardPlan", "plan_shard", "resolve_devices",
           "note_plan", "plans_report", "clear_plans", "MODES", "AXIS"]

MODES = ("off", "auto", "data", "model")

#: the shard plane's mesh axis name (one axis)
AXIS = "dev"

#: stage-name markers of the interior stages the model split targets
_MODEL_MARKERS = ("fft", "pfb", "channelizer")


@dataclass
class StageDecision:
    """One stage's verdict: ``data`` lanes, ``model`` (the stage splits
    across spans) or ``replicate`` (it cannot), and why, when that is not
    what the requested mode asked for."""
    stage: str
    index: int
    mode: str
    reason: Optional[str] = None

    def as_dict(self) -> dict:
        out = {"stage": self.stage, "index": self.index, "mode": self.mode}
        if self.reason:
            out["reason"] = self.reason
        return out


@dataclass
class ShardPlan:
    """The pass's output: requested and applied mode, device count and axis,
    the stages' decisions and the declines. ``applied == "off"`` is the
    identity contract: the caller hands back the unchanged program."""
    mode: str
    applied: str                    # "off" | "data" | "model"
    n_devices: int
    axis: str = AXIS
    decisions: List[StageDecision] = field(default_factory=list)
    declined: List[str] = field(default_factory=list)
    device: Optional[str] = None    # the base device (None: the cards)

    @property
    def active(self) -> bool:
        return self.applied != "off" and self.n_devices > 1

    def describe(self) -> dict:
        return {"mode": self.mode, "applied": self.applied, "n_devices": self.n_devices,
                "axis": self.axis, "stages": [d.as_dict() for d in self.decisions],
                "declined": list(self.declined)}


def resolve_devices(n_devices: Optional[int] = None, device=None) -> int:
    """The device count a plan targets: an explicit request (refused when
    more than exist), else config ``shard_devices``, else every device
    :func:`~futuresdr_tpu_torch.parallel.mesh.visible_devices` lists (1 when
    none is)."""
    from ..config import config
    from ..parallel.mesh import visible_devices
    try:
        avail = len(visible_devices(device))
    except RuntimeError:                       # no card
        avail = 1
    if n_devices is None:
        n_devices = int(config().shard_devices or 0) or avail
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(f"shard plan needs >= 1 device, got {n_devices}")
    if n_devices > avail:
        raise ValueError(f"shard plan requests {n_devices} devices but only {avail} "
                         f"exist — a truncated mesh would silently change the program; "
                         f"pass n_devices<={avail} (or set config virtual_devices)")
    return n_devices


def _is_model_stage(stage) -> bool:
    """An FFT-backed or polyphase interior stage: what the model split is
    for (the reference's test)."""
    name = str(getattr(stage, "name", "")).lower()
    if any(m in name for m in _MODEL_MARKERS):
        return True
    return getattr(stage, "lti", None) is not None


def _splits(stage) -> bool:
    """Can the stage run span by span: an input-history window, or no
    state at all?"""
    from ..ops.stages import _stateless
    return getattr(stage, "history", 0) > 0 or getattr(stage, "init_carry", None) is _stateless


def plan_shard(pipeline, mode: Optional[str] = None, n_devices: Optional[int] = None,
               frame_size: Optional[int] = None, axis: str = AXIS,
               device=None) -> ShardPlan:
    """Run the pass. ``mode=None`` reads config ``shard`` ("off" by
    default); ``device`` is the base device (None: the cards; ``"cpu"`` with
    config ``virtual_devices``). Raises ``ValueError`` for an unknown mode or
    an over-sized request; records declines."""
    from ..config import config
    if mode is None:
        mode = str(config().shard or "off")
    mode = str(mode).strip().lower()
    if mode not in MODES:
        raise ValueError(f"unknown shard mode {mode!r} (one of {MODES})")
    dev = None if device is None else str(device)
    if mode == "off":
        return ShardPlan(mode, "off", 1, axis, device=dev)
    n = resolve_devices(n_devices, device)
    if n == 1:
        return ShardPlan(mode, "off", 1, axis, device=dev)

    stages = list(getattr(pipeline, "stages", []))
    declined: List[str] = []
    applied = "data" if mode in ("auto", "data") else "model"
    stuck: List[str] = []
    if applied == "model":
        stuck = [str(getattr(s, "name", f"stage{i}")) for i, s in enumerate(stages)
                 if not _splits(s)]
        if frame_size is not None and int(frame_size) % n != 0:
            declined.append(f"model: frame_size {frame_size} not divisible by {n} devices "
                            f"— fell back to data sharding")
            applied = "data"
        elif not any(_is_model_stage(s) for s in stages):
            declined.append("model: no FFT/PFB interior stage to decompose — fell back "
                            "to data sharding")
            applied = "data"
        elif getattr(pipeline, "n_branches", 0):
            declined.append("model: multi-sink (fan-out/DAG) program — per-sink rate "
                            "contracts do not share one item-axis split; fell back to "
                            "data sharding")
            applied = "data"
        elif stuck:
            declined.append(f"model: stage(s) {stuck} carry state that is not an "
                            f"input-history window and would replicate — fell back to "
                            f"data sharding")
            applied = "data"

    decisions = []
    for i, s in enumerate(stages):
        name = str(getattr(s, "name", f"stage{i}"))
        if applied == "data" and name in stuck:
            decisions.append(StageDecision(
                name, i, "replicate", "its carry is not an input-history window; the "
                                      "plan fell back to data"))
        elif applied == "data":
            reason = None
            if mode == "model":
                reason = "plan fell back to data (see declined)"
            elif _is_model_stage(s):
                reason = "model-capable (mode=model would decompose it)"
            decisions.append(StageDecision(name, i, "data", reason))
        else:
            decisions.append(StageDecision(name, i, "model", None))
    return ShardPlan(mode, applied, n, axis, decisions, declined, device=dev)


_plans_lock = threading.Lock()
_plans: dict = {}


def note_plan(name: str, plan: ShardPlan, extra: Optional[dict] = None) -> None:
    """Publish a program's plan under its name; ``extra`` merges a runner's
    live counts (dispatches, frames a shard, replayed groups)."""
    entry = plan.describe()
    if extra:
        entry.update(extra)
    with _plans_lock:
        _plans[str(name)] = entry


def plans_report() -> dict:
    with _plans_lock:
        return {k: dict(v) for k, v in _plans.items()}


def clear_plans() -> None:
    with _plans_lock:
        _plans.clear()
