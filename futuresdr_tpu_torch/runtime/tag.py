"""Stream tags: item-indexed metadata riding alongside samples.

A copy of ``futuresdr_tpu/runtime/tag.py``: a ``Tag`` is an anonymous id,
string or Pmt, or a named usize, f32 or any value; ``ItemTag`` attaches one
to a stream item, and tags are index-rebased as the reader consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional

from ..types import Pmt

__all__ = ["Tag", "ItemTag", "rebase_tags", "filter_tags"]


@dataclass(frozen=True)
class Tag:
    """A tag value. ``name`` is None for anonymous Id/String/Pmt tags."""

    kind: str                 # "id" | "string" | "pmt" | "usize" | "f32" | "any"
    value: Any
    name: Optional[str] = None

    @classmethod
    def id(cls, v: int) -> "Tag":
        return cls("id", int(v))

    @classmethod
    def string(cls, s: str) -> "Tag":
        return cls("string", str(s))

    @classmethod
    def pmt(cls, p: Pmt) -> "Tag":
        return cls("pmt", p)

    @classmethod
    def named_usize(cls, name: str, v: int) -> "Tag":
        return cls("usize", int(v), name)

    @classmethod
    def named_f32(cls, name: str, v: float) -> "Tag":
        return cls("f32", float(v), name)

    @classmethod
    def named_any(cls, name: str, v: Any) -> "Tag":
        return cls("any", v, name)


@dataclass(frozen=True)
class ItemTag:
    """A tag attached to the stream item at ``index``."""

    index: int
    tag: Tag


def rebase_tags(tags: Iterable[ItemTag], offset: int) -> List[ItemTag]:
    """Shift tag indices by ``-offset``, dropping tags now in the past."""
    return [ItemTag(t.index - offset, t.tag) for t in tags if t.index >= offset]


def filter_tags(tags: Iterable[ItemTag], n: int) -> List[ItemTag]:
    """Tags visible in a window of ``n`` items from the read position."""
    return [t for t in tags if 0 <= t.index < n]
