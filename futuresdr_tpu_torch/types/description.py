"""Introspection descriptions served over the control plane (a copy of
``futuresdr_tpu/types/description.py``).

Reference: ``crates/types/src/description.rs:12-46`` (``FlowgraphDescription``,
``BlockDescription``). These are what the REST API and GUI consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import List, Optional

__all__ = ["BlockDescription", "FlowgraphDescription"]


@dataclass
class BlockDescription:
    id: int
    type_name: str
    instance_name: str
    stream_inputs: List[str] = field(default_factory=list)
    stream_outputs: List[str] = field(default_factory=list)
    message_inputs: List[str] = field(default_factory=list)
    message_outputs: List[str] = field(default_factory=list)
    blocking: bool = False
    # failure-policy surface (docs/robustness.md): the resolved per-block
    # policy and how many restart attempts the supervisor has billed — so
    # `GET /api/fg/{fg}/` tells an operator WHICH block is flapping without
    # scraping /metrics
    policy: str = "fail_fast"
    restarts: int = 0
    # isolate-group membership (docs/robustness.md): a member's failure
    # retires the whole named subgraph — None when the block has no group
    isolate_group: Optional[str] = None

    def to_json(self):
        return asdict(self)


@dataclass
class FlowgraphDescription:
    id: int
    blocks: List[BlockDescription] = field(default_factory=list)
    stream_edges: List[tuple] = field(default_factory=list)  # (src_blk, src_port, dst_blk, dst_port)
    message_edges: List[tuple] = field(default_factory=list)
    # the supervisor's policy-action log (restart attempts, isolations,
    # restart-exhausted escalations, cancels) — live during the run, final
    # after it (the same dicts a FlowgraphError carries on failure, surfaced
    # here for runs that RECOVERED)
    policy_decisions: List[dict] = field(default_factory=list)

    def to_json(self):
        return {
            "id": self.id,
            "blocks": [b.to_json() for b in self.blocks],
            "stream_edges": [list(e) for e in self.stream_edges],
            "message_edges": [list(e) for e in self.message_edges],
            "policy_decisions": list(self.policy_decisions),
        }
