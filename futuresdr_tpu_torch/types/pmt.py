"""Polymorphic message type (PMT) — the value type of the message plane.

A copy of ``futuresdr_tpu/types/pmt.py``, itself a re-design of the reference's ``Pmt``
enum (futuresdr-types, ``crates/types/src/pmt.rs:77-131``): a tagged union that is JSON-serializable for the REST control plane, with typed accessors and
lossless numpy vector payloads. Unlike the Rust enum, Python values are carried directly and the
kind tag is derived; an explicit kind can be forced for wire-format fidelity (e.g. U32 vs U64).
"""

from __future__ import annotations

import base64
import enum
from typing import Any, Mapping

import numpy as np

__all__ = ["Pmt", "PmtKind", "PmtConversionError"]


class PmtKind(enum.Enum):
    """Kind tag mirroring the reference's ``PmtKind`` (``pmt.rs:232-270``)."""

    OK = "Ok"
    INVALID_VALUE = "InvalidValue"
    NULL = "Null"
    STRING = "String"
    BOOL = "Bool"
    USIZE = "Usize"
    ISIZE = "Isize"
    U32 = "U32"
    U64 = "U64"
    F32 = "F32"
    F64 = "F64"
    VEC_CF32 = "VecCF32"
    VEC_F32 = "VecF32"
    VEC_U64 = "VecU64"
    BLOB = "Blob"
    VEC_PMT = "VecPmt"
    FINISHED = "Finished"
    MAP_STR_PMT = "MapStrPmt"
    ANY = "Any"


class PmtConversionError(TypeError):
    """Raised by typed accessors when the held kind cannot convert (``pmt.rs: TryFrom impls``)."""


_SENTINEL_KINDS = (PmtKind.OK, PmtKind.INVALID_VALUE, PmtKind.NULL, PmtKind.FINISHED)


class Pmt:
    """A single polymorphic message value.

    Construct via the classmethod constructors (``Pmt.f64(3.0)``, ``Pmt.ok()``, …) or infer from a
    Python object with :meth:`from_py`. Values are immutable by convention (vectors are stored as
    read-only numpy arrays).
    """

    __slots__ = ("kind", "value")

    def __init__(self, kind: PmtKind, value: Any = None):
        if kind in (PmtKind.VEC_F32, PmtKind.VEC_CF32, PmtKind.VEC_U64):
            dtype = {
                PmtKind.VEC_F32: np.float32,
                PmtKind.VEC_CF32: np.complex64,
                PmtKind.VEC_U64: np.uint64,
            }[kind]
            value = np.asarray(value, dtype=dtype)
            value.setflags(write=False)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "value", value)

    def __setattr__(self, name: str, value: Any):  # immutability
        raise AttributeError("Pmt is immutable")

    # ---- constructors -------------------------------------------------------
    # No-payload kinds are interned singletons: Pmt is immutable (enforced by
    # __setattr__), and the message plane returns Pmt.ok() per delivered
    # message — ~450k allocations per 50k-burst perf/msg run otherwise
    @classmethod
    def ok(cls) -> "Pmt":
        return _OK

    @classmethod
    def invalid_value(cls) -> "Pmt":
        return _INVALID

    @classmethod
    def null(cls) -> "Pmt":
        return _NULL

    @classmethod
    def finished(cls) -> "Pmt":
        return _FINISHED

    @classmethod
    def string(cls, s: str) -> "Pmt":
        return cls(PmtKind.STRING, str(s))

    @classmethod
    def bool_(cls, b: bool) -> "Pmt":
        return cls(PmtKind.BOOL, bool(b))

    @classmethod
    def usize(cls, v: int) -> "Pmt":
        return cls(PmtKind.USIZE, int(v))

    @classmethod
    def isize(cls, v: int) -> "Pmt":
        return cls(PmtKind.ISIZE, int(v))

    @classmethod
    def u32(cls, v: int) -> "Pmt":
        return cls(PmtKind.U32, int(v) & 0xFFFFFFFF)

    @classmethod
    def u64(cls, v: int) -> "Pmt":
        return cls(PmtKind.U64, int(v) & 0xFFFFFFFFFFFFFFFF)

    @classmethod
    def f32(cls, v: float) -> "Pmt":
        return cls(PmtKind.F32, float(np.float32(v)))

    @classmethod
    def f64(cls, v: float) -> "Pmt":
        return cls(PmtKind.F64, float(v))

    @classmethod
    def vec_f32(cls, v) -> "Pmt":
        return cls(PmtKind.VEC_F32, v)

    @classmethod
    def vec_cf32(cls, v) -> "Pmt":
        return cls(PmtKind.VEC_CF32, v)

    @classmethod
    def vec_u64(cls, v) -> "Pmt":
        return cls(PmtKind.VEC_U64, v)

    @classmethod
    def blob(cls, b: bytes) -> "Pmt":
        return cls(PmtKind.BLOB, bytes(b))

    @classmethod
    def vec(cls, items) -> "Pmt":
        return cls(PmtKind.VEC_PMT, tuple(cls.from_py(i) for i in items))

    @classmethod
    def map(cls, m: Mapping[str, Any]) -> "Pmt":
        return cls(PmtKind.MAP_STR_PMT, {str(k): cls.from_py(v) for k, v in m.items()})

    @classmethod
    def any_(cls, obj: Any) -> "Pmt":
        """Opaque payload; skipped by serde, like the reference's ``Pmt::Any`` (``pmt.rs:130``)."""
        return cls(PmtKind.ANY, obj)

    @classmethod
    def from_py(cls, obj: Any) -> "Pmt":
        """Infer a Pmt from a natural Python/numpy object."""
        if isinstance(obj, Pmt):
            return obj
        if obj is None:
            return cls.null()
        if isinstance(obj, bool):
            return cls.bool_(obj)
        if isinstance(obj, (int, np.integer)):
            return cls.usize(int(obj)) if obj >= 0 else cls.isize(int(obj))
        if isinstance(obj, (float, np.floating)):
            return cls.f64(float(obj))
        if isinstance(obj, str):
            return cls.string(obj)
        if isinstance(obj, (bytes, bytearray, memoryview)):
            return cls.blob(bytes(obj))
        if isinstance(obj, np.ndarray):
            if np.issubdtype(obj.dtype, np.complexfloating):
                return cls.vec_cf32(obj)
            if np.issubdtype(obj.dtype, np.floating):
                return cls.vec_f32(obj)
            if np.issubdtype(obj.dtype, np.unsignedinteger):
                return cls.vec_u64(obj)
            return cls.vec(obj.tolist())
        if isinstance(obj, Mapping):
            return cls.map(obj)
        if isinstance(obj, (list, tuple)):
            return cls.vec(obj)
        return cls.any_(obj)

    # ---- typed accessors ----------------------------------------------------
    def _expect(self, *kinds: PmtKind):
        if self.kind not in kinds:
            raise PmtConversionError(f"Pmt kind {self.kind.value} not convertible (wanted {[k.value for k in kinds]})")

    def to_bool(self) -> bool:
        self._expect(PmtKind.BOOL)
        return self.value

    def to_int(self) -> int:
        self._expect(PmtKind.USIZE, PmtKind.ISIZE, PmtKind.U32, PmtKind.U64)
        return self.value

    def to_float(self) -> float:
        if self.kind in (PmtKind.F32, PmtKind.F64):
            return self.value
        if self.kind in (PmtKind.USIZE, PmtKind.ISIZE, PmtKind.U32, PmtKind.U64):
            return float(self.value)
        raise PmtConversionError(f"Pmt kind {self.kind.value} not convertible to float")

    def to_str(self) -> str:
        self._expect(PmtKind.STRING)
        return self.value

    def to_ndarray(self) -> np.ndarray:
        self._expect(PmtKind.VEC_F32, PmtKind.VEC_CF32, PmtKind.VEC_U64)
        return self.value

    def to_blob(self) -> bytes:
        self._expect(PmtKind.BLOB)
        return self.value

    def to_map(self) -> dict:
        self._expect(PmtKind.MAP_STR_PMT)
        return dict(self.value)

    def is_finished(self) -> bool:
        return self.kind is PmtKind.FINISHED

    # ---- equality / repr ----------------------------------------------------
    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Pmt):
            return NotImplemented
        if self.kind is not other.kind:
            return False
        if isinstance(self.value, np.ndarray):
            return bool(np.array_equal(self.value, other.value))
        return self.value == other.value

    def __hash__(self):
        v = self.value
        if isinstance(v, np.ndarray):
            v = v.tobytes()
        elif isinstance(v, dict):
            v = tuple(sorted(v.items()))
        return hash((self.kind, v))

    def __repr__(self):
        if self.kind in _SENTINEL_KINDS:
            return f"Pmt.{self.kind.value}"
        return f"Pmt.{self.kind.value}({self.value!r})"

    # ---- JSON serde (wire format of the REST control plane) -----------------
    def to_json(self) -> Any:
        """Serialize in the same externally-tagged style serde uses for the Rust enum."""
        k = self.kind
        if k in _SENTINEL_KINDS:
            return k.value
        if k is PmtKind.ANY:
            return PmtKind.NULL.value  # Any is skipped on the wire (pmt.rs `serde(skip)`)
        if k in (PmtKind.VEC_F32, PmtKind.VEC_CF32, PmtKind.VEC_U64):
            if k is PmtKind.VEC_CF32:
                payload = [[float(c.real), float(c.imag)] for c in self.value]
            else:
                payload = [v.item() for v in self.value]
            return {k.value: payload}
        if k is PmtKind.BLOB:
            return {k.value: base64.b64encode(self.value).decode("ascii")}
        if k is PmtKind.VEC_PMT:
            return {k.value: [p.to_json() for p in self.value]}
        if k is PmtKind.MAP_STR_PMT:
            return {k.value: {n: p.to_json() for n, p in self.value.items()}}
        return {k.value: self.value}

    @classmethod
    def from_json(cls, obj: Any) -> "Pmt":
        if isinstance(obj, str):
            for k in _SENTINEL_KINDS:
                if obj == k.value:
                    return cls(k)
            return cls.string(obj)  # convenience: bare strings accepted like reference's FromStr
        if isinstance(obj, bool):
            return cls.bool_(obj)
        if isinstance(obj, int):
            return cls.usize(obj) if obj >= 0 else cls.isize(obj)
        if isinstance(obj, float):
            return cls.f64(obj)
        if isinstance(obj, dict) and len(obj) == 1:
            (tag, payload), = obj.items()
            try:
                k = PmtKind(tag)
            except ValueError:
                raise PmtConversionError(f"unknown Pmt tag {tag!r}")
            if k is PmtKind.VEC_CF32:
                return cls.vec_cf32([complex(re, im) for re, im in payload])
            if k is PmtKind.BLOB:
                return cls.blob(base64.b64decode(payload))
            if k is PmtKind.VEC_PMT:
                return cls(PmtKind.VEC_PMT, tuple(cls.from_json(p) for p in payload))
            if k is PmtKind.MAP_STR_PMT:
                return cls(PmtKind.MAP_STR_PMT, {n: cls.from_json(p) for n, p in payload.items()})
            if k is PmtKind.STRING:
                return cls.string(payload)
            if k is PmtKind.BOOL:
                return cls.bool_(payload)
            if k in (PmtKind.USIZE, PmtKind.ISIZE, PmtKind.U32, PmtKind.U64):
                return cls(k, int(payload))
            if k in (PmtKind.F32, PmtKind.F64):
                return cls(k, float(payload))
            if k in (PmtKind.VEC_F32, PmtKind.VEC_U64):
                return cls(k, payload)
            if k in _SENTINEL_KINDS:
                return cls(k)
        raise PmtConversionError(f"cannot deserialize Pmt from {obj!r}")


# interned no-payload singletons (see Pmt.ok)
_OK = Pmt(PmtKind.OK)
_INVALID = Pmt(PmtKind.INVALID_VALUE)
_NULL = Pmt(PmtKind.NULL)
_FINISHED = Pmt(PmtKind.FINISHED)
