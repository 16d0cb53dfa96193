"""The port's ``Pmt`` against the JAX package's.

The cases of ``tests/test_pmt.py`` on ``futuresdr_tpu_torch.types``, and a
seeded set of Pmts of every kind whose JSON text is the same in both
packages and which each package parses from the other's JSON.
"""

import json

import numpy as np
import pytest
import torch

from futuresdr_tpu import types as J
from futuresdr_tpu_torch import types as T
from futuresdr_tpu_torch.types import Pmt, PmtConversionError, PmtKind

# One intra-op thread: the suite runs in several worker processes at once, and
# torch's default of one thread a core in each would oversubscribe the cores.
torch.set_num_threads(1)


def test_constructors_and_kinds():
    assert Pmt.ok().kind is PmtKind.OK
    assert Pmt.null().kind is PmtKind.NULL
    assert Pmt.finished().is_finished()
    assert Pmt.f32(1.5).kind is PmtKind.F32
    assert Pmt.u32(2**32 + 2).value == 2  # wraps like the fixed-width type


def test_from_py_inference():
    assert Pmt.from_py(True).kind is PmtKind.BOOL
    assert Pmt.from_py(3).kind is PmtKind.USIZE
    assert Pmt.from_py(-3).kind is PmtKind.ISIZE
    assert Pmt.from_py(3.5).kind is PmtKind.F64
    assert Pmt.from_py("hi").kind is PmtKind.STRING
    assert Pmt.from_py(b"ab").kind is PmtKind.BLOB
    assert Pmt.from_py(np.zeros(4, np.float32)).kind is PmtKind.VEC_F32
    assert Pmt.from_py(np.zeros(4, np.complex64)).kind is PmtKind.VEC_CF32
    assert Pmt.from_py({"a": 1}).kind is PmtKind.MAP_STR_PMT
    assert Pmt.from_py([1, 2]).kind is PmtKind.VEC_PMT


def test_equality():
    assert Pmt.f64(2.0) == Pmt.f64(2.0)
    assert Pmt.f64(2.0) != Pmt.f32(2.0)
    assert Pmt.vec_f32([1, 2]) == Pmt.vec_f32([1, 2])
    assert Pmt.string("a") != Pmt.string("b")


def test_accessors_and_errors():
    assert Pmt.usize(7).to_int() == 7
    assert Pmt.f64(2.5).to_float() == 2.5
    assert Pmt.usize(7).to_float() == 7.0
    with pytest.raises(PmtConversionError):
        Pmt.string("x").to_int()
    with pytest.raises(PmtConversionError):
        Pmt.null().to_ndarray()


ROUNDTRIP = [
    lambda m: m.Pmt.ok(),
    lambda m: m.Pmt.null(),
    lambda m: m.Pmt.finished(),
    lambda m: m.Pmt.string("hello"),
    lambda m: m.Pmt.bool_(True),
    lambda m: m.Pmt.usize(42),
    lambda m: m.Pmt.isize(-42),
    lambda m: m.Pmt.u32(7),
    lambda m: m.Pmt.u64(1 << 40),
    lambda m: m.Pmt.f32(1.5),
    lambda m: m.Pmt.f64(-2.25),
    lambda m: m.Pmt.vec_f32([1.0, 2.0, 3.0]),
    lambda m: m.Pmt.vec_cf32([1 + 2j, 3 - 4j]),
    lambda m: m.Pmt.vec_u64([1, 2, 3]),
    lambda m: m.Pmt.blob(b"\x00\x01\xff"),
    lambda m: m.Pmt.vec([1, "two", 3.0]),
    lambda m: m.Pmt.map({"freq": 100e6, "gain": 30}),
]


@pytest.mark.parametrize("make", ROUNDTRIP)
def test_json_roundtrip(make):
    p = make(T)
    q = Pmt.from_json(json.loads(json.dumps(p.to_json())))
    assert q == p, f"roundtrip failed for {p!r}: got {q!r}"


def test_immutable():
    p = Pmt.f64(1.0)
    with pytest.raises(AttributeError):
        p.value = 2.0
    arr = Pmt.vec_f32([1, 2]).to_ndarray()
    with pytest.raises(ValueError):
        arr[0] = 9


def test_kinds_match_the_jax_package():
    assert [(k.name, k.value) for k in T.PmtKind] == [(k.name, k.value) for k in J.PmtKind]


def _seeded_values(seed: int, n: int):
    """``n`` Python values of every kind Pmt.from_py infers, from ``seed``;
    maps and lists nest one level."""
    rng = np.random.default_rng(seed)

    def leaf():
        kind = rng.integers(0, 9)
        if kind == 0:
            return bool(rng.integers(0, 2))
        if kind == 1:
            return int(rng.integers(0, 1 << 40))
        if kind == 2:
            return -int(rng.integers(1, 1 << 30))
        if kind == 3:
            return float(rng.standard_normal() * 1e6)
        if kind == 4:
            return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 6))
        if kind == 5:
            return rng.integers(0, 256, int(rng.integers(0, 9))).astype(np.uint8).tobytes()
        if kind == 6:
            return rng.standard_normal(int(rng.integers(1, 6))).astype(np.float32)
        if kind == 7:
            k = int(rng.integers(1, 6))
            return (rng.standard_normal(k) + 1j * rng.standard_normal(k)).astype(np.complex64)
        return rng.integers(0, 1 << 60, int(rng.integers(1, 5))).astype(np.uint64)

    out = []
    for i in range(n):
        shape = i % 3
        if shape == 0:
            out.append(leaf())
        elif shape == 1:
            out.append([leaf() for _ in range(int(rng.integers(0, 4)))])
        else:
            out.append({f"k{j}": leaf() for j in range(int(rng.integers(0, 4)))})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_pmts_serialize_alike_and_parse_each_others_json(seed):
    for value in _seeded_values(seed, 60):
        tp, jp = T.Pmt.from_py(value), J.Pmt.from_py(value)
        t_text, j_text = json.dumps(tp.to_json()), json.dumps(jp.to_json())
        assert t_text == j_text, value
        assert T.Pmt.from_json(json.loads(j_text)) == tp
        assert J.Pmt.from_json(json.loads(t_text)) == jp
        assert repr(tp) == repr(jp)


@pytest.mark.parametrize("kind,value", [("U32", 7), ("U64", 1 << 40), ("F32", 1.5),
                                        ("Usize", 7), ("Isize", -7)])
def test_fixed_width_kinds_keep_their_tag_in_both_packages(kind, value):
    wire = json.dumps({kind: value})
    tp, jp = T.Pmt.from_json(json.loads(wire)), J.Pmt.from_json(json.loads(wire))
    assert tp.kind.value == jp.kind.value == kind
    assert json.dumps(tp.to_json()) == json.dumps(jp.to_json()) == wire
