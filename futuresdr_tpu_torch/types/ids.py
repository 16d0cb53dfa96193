"""Identifier newtypes for flowgraphs, blocks, and ports (a copy of
``futuresdr_tpu/types/ids.py``).

Reference: ``crates/types/src/port_id.rs:6`` and the ``BlockId``/``FlowgraphId`` usizes used
throughout the runtime. Here they are light value types so they can flow through JSON unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

__all__ = ["BlockId", "FlowgraphId", "PortId"]

BlockId = int
FlowgraphId = int


@dataclass(frozen=True)
class PortId:
    """A port addressed either by index or by name (``port_id.rs:6-14``)."""

    id: Union[int, str]

    @classmethod
    def coerce(cls, v: Union["PortId", int, str]) -> "PortId":
        return v if isinstance(v, PortId) else cls(v)

    def __str__(self):
        return str(self.id)
