"""Wire formats for every host <-> device crossing of the streamed path.

The port's copy of ``futuresdr_tpu/ops/wire.py``. A :class:`Wire` turns a
logical frame (complex64 or float32 stream samples) into **wire parts**, a
tuple of small-dtype arrays that cross the link, and back, on both ends:

    host:   encode_host(frame)    -> parts   (numpy, the reference's code)
    device: decode_torch(parts)   -> frame   (inside the program's CUDA graph)
    device: encode_torch(frame)   -> parts   (inside the program's CUDA graph)
    host:   decode_host(parts)    -> frame   (numpy, the reference's code)

Part layouts are the same in both directions, so a host
``encode_host -> decode_host`` round trip measures exactly what one crossing
does to the samples (:func:`measure_snr_db`).

========  ==============  ==========================  ====================
name      c64 B/sample    layout                      SNR (c64, nominal)
========  ==============  ==========================  ====================
``f32``   8               float32 IQ pairs            exact
``bf16``  4               bfloat16 IQ pairs           ~54 dB
``sc16``  4               int16 IQ + per-frame scale  ~90 dB
``sc8``   2               int8 IQ + per-frame scale   ~41 dB
========  ==============  ==========================  ====================

``sc16``/``sc8`` are block floating point: one float32 scale, the frame's
``max(|I|, |Q|)``, rides beside the int payload. A megabatch group of K
frames ships K scales, one a frame (a ``[K]`` part), so a quiet frame in a
loud group keeps its own SNR. Non-finite samples are zeroed on both sides
(an int payload cannot carry them, and one must not poison the scale).
Non-float payloads pass through every format unchanged.

The device codecs are written for graph capture: no ``.item()`` and no
Python branch on a device value (the "peak <= 0 means 1" rule is a
``torch.where``), and ``torch.round`` rounds half to even as ``np.round``
does. Two numerical contracts follow:

* ``decode_torch`` is ``decode_host`` bit for bit (``q * (scale / qmax)``,
  float32 throughout);
* ``encode_torch`` is ``encode_host`` bit for bit: the multiplier
  ``qmax / peak`` is divided in float64 and rounded to float32, as numpy
  does with a Python float (XLA:CPU divides in float32, so the reference's
  ``encode_jax`` may differ from both by one payload LSB).

The bfloat16 payload is carried as its 16 bits in an int16 array on the host
(numpy has no bfloat16; the rounding is float32's round to nearest even, and
every NaN becomes ``sign | 0x7fc0``, as ``ml_dtypes`` does) and viewed as
``torch.bfloat16`` on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Wire", "F32Wire", "Bf16Wire", "Sc16Wire", "Sc8Wire", "WIRE_FORMATS",
           "get_wire", "resolve_wire", "wire_names", "measure_snr_db",
           "streamed_ceiling_msps"]


def _is_float(dt) -> bool:
    return np.dtype(dt).kind in "fc"


def _is_complex(dt) -> bool:
    return np.dtype(dt).kind == "c"


def _pairs_view(a: np.ndarray) -> np.ndarray:
    """complex (…) -> float re/im pairs (…, 2), a view when contiguous."""
    f = np.float64 if a.dtype == np.complex128 else np.float32
    return np.ascontiguousarray(a).view(f).reshape(a.shape + (2,))


def _join_pairs_np(p: np.ndarray, dt: np.dtype) -> np.ndarray:
    """float32 pairs (…, 2) -> complex (…), a view when contiguous."""
    p = np.ascontiguousarray(np.asarray(p, dtype=np.float32))
    return p.view(np.complex64).reshape(p.shape[:-1]).astype(dt, copy=False)


def _pairs_torch(y: torch.Tensor) -> torch.Tensor:
    """complex (…) -> float32 pairs (…, 2) on the device."""
    return torch.view_as_real(y.to(torch.complex64)).contiguous()


def _join_pairs_torch(x: torch.Tensor) -> torch.Tensor:
    """float32 pairs (…, 2) -> complex64 (…) on the device, a view."""
    return torch.view_as_complex(x.contiguous())


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> the bits of the nearest bfloat16 (round half to even;
    every NaN to ``sign | 0x7fc0``) as int16, the host's bfloat16 payload."""
    f = np.ascontiguousarray(a, dtype=np.float32)
    u = f.view(np.uint32)
    r = (u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16
    nan = ((u >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    return np.where(np.isnan(f), nan, r).astype(np.uint16).view(np.int16)


def bf16_to_float(bits: np.ndarray) -> np.ndarray:
    """The int16 bits of bfloat16 values -> float32 (exact)."""
    b = np.ascontiguousarray(bits).view(np.uint16).astype(np.uint32)
    return (b << 16).view(np.float32)


class Wire:
    """One wire format. Stateless; instances are shared through
    :data:`WIRE_FORMATS`."""

    name = "?"
    #: nominal SNR in dB for a full-scale c64 stream (None: exact)
    nominal_snr_db: Optional[float] = None

    def __init__(self):
        self._part_counts: dict = {}

    def bytes_per_sample(self, dtype) -> int:
        """Bytes one sample of ``dtype`` takes on the wire (the per-frame
        scale amortized away)."""
        raise NotImplementedError

    def part_count(self, dtype) -> int:
        """How many parts one frame of ``dtype`` ships as (a quantizing
        format rides a scale beside its payload), probed once a dtype."""
        dt = np.dtype(dtype)
        n = self._part_counts.get(dt)
        if n is None:
            n = self._part_counts[dt] = len(self.encode_host(np.zeros(1, dt)))
        return n

    def encode_may_alias(self, dtype) -> bool:
        """May :meth:`encode_host` return views of its input? Then a frame
        read out of a ring slot must be copied before the slot is consumed
        (the H2D reads it later)."""
        return True

    def encode_host(self, a: np.ndarray) -> Tuple[np.ndarray, ...]:
        raise NotImplementedError

    def encode_into(self, a: np.ndarray, alloc) -> Tuple[np.ndarray, ...]:
        """:meth:`encode_host` with the output drawn from ``alloc`` (an
        ``ops/arena.GroupAlloc``): bit-identical parts in recycled (pinned)
        buffers. The base form is :meth:`encode_host`."""
        return self.encode_host(a)

    def decode_host(self, parts: Sequence[np.ndarray], dtype) -> np.ndarray:
        raise NotImplementedError

    def decode_torch(self, parts: Sequence[torch.Tensor], dtype) -> torch.Tensor:
        """The device decode of one frame's parts into a ``dtype`` frame."""
        raise NotImplementedError

    def encode_torch(self, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The device encode of one frame into its parts."""
        raise NotImplementedError

    def __repr__(self):
        return f"Wire({self.name})"


class F32Wire(Wire):
    """float32 IQ pairs, bit-exact: the port's float32 link as a codec."""

    name = "f32"
    nominal_snr_db = None

    def bytes_per_sample(self, dtype) -> int:
        return np.dtype(dtype).itemsize

    def encode_host(self, a):
        a = np.asarray(a)
        if _is_complex(a.dtype):
            return (_pairs_view(a),)
        return (np.ascontiguousarray(a),)

    def decode_host(self, parts, dtype):
        dt = np.dtype(dtype)
        (p,) = parts
        if _is_complex(dt):
            return _join_pairs_np(np.asarray(p), dt)
        return np.asarray(p).astype(dt, copy=False)

    def decode_torch(self, parts, dtype):
        (p,) = parts
        if _is_complex(dtype):
            return _join_pairs_torch(p)
        return p

    def encode_torch(self, y):
        if y.is_complex():
            return (_pairs_torch(y),)
        return (y,)


class Bf16Wire(Wire):
    """bfloat16 IQ pairs: float32 with an 8-bit mantissa, half the bytes,
    no scale, any dynamic range."""

    name = "bf16"
    nominal_snr_db = 54.0

    def encode_may_alias(self, dtype) -> bool:
        return not _is_float(dtype)

    def bytes_per_sample(self, dtype) -> int:
        dt = np.dtype(dtype)
        if not _is_float(dt):
            return dt.itemsize
        return 4 if _is_complex(dt) else 2

    def encode_host(self, a):
        a = np.asarray(a)
        if _is_complex(a.dtype):
            return (bf16_bits(_pairs_view(a.astype(np.complex64, copy=False))),)
        if a.dtype.kind == "f":
            return (bf16_bits(a),)
        return (np.ascontiguousarray(a),)

    def decode_host(self, parts, dtype):
        dt = np.dtype(dtype)
        (p,) = parts
        p = np.asarray(p)
        if _is_complex(dt):
            return _join_pairs_np(bf16_to_float(p), dt)
        if dt.kind == "f":
            return bf16_to_float(p).astype(dt, copy=False)
        return p

    def decode_torch(self, parts, dtype):
        dt = np.dtype(dtype)
        (p,) = parts
        if not _is_float(dt):
            return p
        f = p.view(torch.bfloat16).float()
        if _is_complex(dt):
            return _join_pairs_torch(f)
        return f

    def encode_torch(self, y):
        if y.is_complex():
            return (_pairs_torch(y).to(torch.bfloat16).view(torch.int16),)
        if y.is_floating_point():
            return (y.float().to(torch.bfloat16).view(torch.int16),)
        return (y,)


class _QuantWire(Wire):
    """Block-floating-point int IQ: ``q = round(x * qmax / scale)`` with
    ``scale = max(|I|, |Q|)`` over the frame, one float32 beside the
    payload. The error is uniform in ±scale/(2·qmax), so SNR ≈ 6.02·bits +
    1.76 − PAPR dB. Non-finite samples are zeroed."""

    itype: np.dtype
    qmax: float

    def encode_may_alias(self, dtype) -> bool:
        return not _is_float(dtype)

    def bytes_per_sample(self, dtype) -> int:
        dt = np.dtype(dtype)
        if not _is_float(dt):
            return dt.itemsize
        unit = np.dtype(self.itype).itemsize
        return 2 * unit if _is_complex(dt) else unit

    def _flat_host(self, a: np.ndarray):
        if _is_complex(a.dtype):
            return _pairs_view(a.astype(np.complex64, copy=False))
        return a.astype(np.float32, copy=False)

    def _peak(self, flat: np.ndarray):
        peak = float(np.max(np.abs(flat))) if flat.size else 0.0
        if not np.isfinite(peak):
            flat = np.where(np.isfinite(flat), flat, np.float32(0.0))
            peak = float(np.max(np.abs(flat))) if flat.size else 0.0
        if peak <= 0.0:
            peak = 1.0
        return flat, peak

    def encode_host(self, a):
        a = np.asarray(a)
        if not _is_float(a.dtype):
            return (np.ascontiguousarray(a),)
        flat, peak = self._peak(self._flat_host(a))
        q = np.round(flat * (self.qmax / peak)).astype(self.itype)
        return (q, np.float32(peak))

    def encode_into(self, a, alloc):
        """The arena path: the int payload lands in ``alloc``'s buffer, the
        float scratch is a temp released before returning; the same
        multiply, round and cast as :meth:`encode_host`, so the same bits."""
        a = np.asarray(a)
        if not _is_float(a.dtype):
            return (np.ascontiguousarray(a),)
        flat, peak = self._peak(self._flat_host(a))
        scratch = alloc.temp(flat.shape, np.float32)
        np.multiply(flat, np.float32(self.qmax / peak), out=scratch)
        np.round(scratch, out=scratch)
        q = alloc(flat.shape, self.itype)
        np.copyto(q, scratch, casting="unsafe")
        alloc.drop_temps()
        return (q, np.float32(peak))

    def decode_host(self, parts, dtype):
        dt = np.dtype(dtype)
        if not _is_float(dt):
            return np.asarray(parts[0])
        q, scale = parts
        x = np.asarray(q).astype(np.float32) * \
            (np.float32(np.asarray(scale)) / np.float32(self.qmax))
        if _is_complex(dt):
            return _join_pairs_np(x, dt)
        return x.astype(dt, copy=False)

    def decode_torch(self, parts, dtype):
        dt = np.dtype(dtype)
        if not _is_float(dt):
            return parts[0]
        q, scale = parts
        scale = scale.float()
        # a device tensor, not a Python float: CUDA divides by a host scalar
        # as a multiply by its reciprocal, which rounds differently
        qmax = torch.full((), self.qmax, dtype=torch.float32, device=scale.device)
        x = q.float() * (scale / qmax)
        if _is_complex(dt):
            return _join_pairs_torch(x)
        return x

    def encode_torch(self, y):
        if y.is_complex():
            flat = _pairs_torch(y)
        elif y.is_floating_point():
            flat = y.float()
        else:
            return (y,)
        flat = torch.where(torch.isfinite(flat), flat, torch.zeros((), dtype=flat.dtype,
                                                                   device=flat.device))
        one = torch.ones((), dtype=torch.float32, device=flat.device)
        if flat.numel():
            peak = flat.abs().amax()
            scale = torch.where(peak > 0, peak, one)
        else:
            scale = one
        # qmax / scale in float64, rounded to float32: numpy's arithmetic
        # with a Python float, so the payload is encode_host's bit for bit
        qmax = torch.full((), self.qmax, dtype=torch.float64, device=flat.device)
        mult = (qmax / scale.double()).float()
        q = torch.round(flat * mult).to(_torch_itype(self.itype))
        return (q, scale)


def _torch_itype(itype) -> torch.dtype:
    return {np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8}[np.dtype(itype)]


class Sc16Wire(_QuantWire):
    name = "sc16"
    itype = np.int16
    qmax = 32767.0
    nominal_snr_db = 90.0


class Sc8Wire(_QuantWire):
    name = "sc8"
    itype = np.int8
    qmax = 127.0
    nominal_snr_db = 41.0


WIRE_FORMATS = {w.name: w for w in (F32Wire(), Bf16Wire(), Sc16Wire(), Sc8Wire())}


def wire_names() -> tuple:
    return tuple(WIRE_FORMATS)


def get_wire(w) -> Wire:
    """``"sc16"`` or a Wire -> the Wire; raises on an unknown name."""
    if isinstance(w, Wire):
        return w
    try:
        return WIRE_FORMATS[str(w)]
    except KeyError:
        raise KeyError(f"unknown wire format {w!r}; "
                       f"known: {sorted(WIRE_FORMATS)}") from None


def resolve_wire(w, platform: str) -> Wire:
    """A wire choice for a device platform (``torch.device.type``).

    ``None`` reads ``config().tpu_wire_format`` (environment
    ``FUTURESDR_TPU_TPU_WIRE_FORMAT``). ``"auto"`` is ``f32`` on the CPU
    (the "link" is a memcpy; quantizing would only add an encode pass and
    noise) and ``sc16`` on a card (half the bytes at about -90 dB)."""
    if w is None:
        from ..config import config
        w = config().tpu_wire_format
    if isinstance(w, str) and w == "auto":
        w = "f32" if platform == "cpu" else "sc16"
    return get_wire(w)


def measure_snr_db(wire, dtype=np.complex64, n: int = 8192, seed: int = 0) -> float:
    """The codec's measured SNR in dB: a host encode -> decode round trip of
    a unit-power Gaussian frame (one link crossing); ``inf`` when exact."""
    wire = get_wire(wire)
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if not _is_float(dt):
        return float("inf")
    if _is_complex(dt):
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             / np.sqrt(2)).astype(np.complex64)
    else:
        x = rng.standard_normal(n).astype(np.float32)
    y = wire.decode_host(wire.encode_host(x), dt)
    err = float(np.mean(np.abs(y - x) ** 2))
    if err == 0.0:
        return float("inf")
    sig = float(np.mean(np.abs(x) ** 2))
    return 10.0 * np.log10(sig / err)


def streamed_ceiling_msps(wire, h2d_Bps: float, d2h_Bps: float,
                          in_dtype=np.complex64, out_dtype=np.float32,
                          out_per_in: float = 1.0) -> float:
    """The link-bound streamed rate of a wire in Msamples/s:
    ``min(h2d / up_bytes, d2h / (down_bytes · out_per_in))`` (the two
    directions overlap, so the slower one binds)."""
    w = get_wire(wire)
    up = w.bytes_per_sample(in_dtype)
    down = w.bytes_per_sample(out_dtype) * max(out_per_in, 1e-12)
    return min(h2d_Bps / up, d2h_Bps / down) / 1e6
