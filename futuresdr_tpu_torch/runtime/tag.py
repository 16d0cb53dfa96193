"""Stream tags: item-indexed metadata riding alongside samples.

A reduced copy of ``futuresdr_tpu/runtime/tag.py`` (no Pmt tag kind: message
types are not in this slice).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional

__all__ = ["Tag", "ItemTag", "rebase_tags", "filter_tags"]


@dataclass(frozen=True)
class Tag:
    """A tag value. ``name`` is None for anonymous Id/String tags."""

    kind: str                 # "id" | "string" | "usize" | "f32" | "any"
    value: Any
    name: Optional[str] = None


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
