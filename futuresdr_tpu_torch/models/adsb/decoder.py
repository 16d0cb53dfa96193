"""Mode S / ADS-B message decoding and aircraft tracking.

Re-design of the reference's ``Decoder`` + ``Tracker`` (``examples/adsb/src/``): CRC24
validation, DF17 extended squitter decode (identification, airborne position with CPR,
velocity), and an aircraft registry keyed by ICAO address updated from message ports.
The port's copy of ``futuresdr_tpu/models/adsb/decoder.py``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

__all__ = ["crc24", "decode_frame", "AdsbMessage", "Tracker", "Aircraft",
           "cpr_global_decode", "cpr_local_decode"]

_CRC24_POLY = 0xFFF409


def crc24(bits: np.ndarray) -> int:
    """Mode S CRC-24 (generator 0x1FFF409): polynomial division remainder; a frame whose
    last 24 bits are the parity of the first n-24 yields remainder 0."""
    data = [int(b) for b in bits]
    poly = [int(c) for c in f"{(1 << 24) | _CRC24_POLY:b}"]
    for i in range(len(data) - 24):
        if data[i]:
            for j in range(25):
                data[i + j] ^= poly[j]
    out = 0
    for b in data[-24:]:
        out = (out << 1) | b
    return out


def _bits_to_int(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


_CALLSIGN_CHARS = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ##### ###############0123456789######"


@dataclass
class AdsbMessage:
    df: int
    icao: int
    type_code: int = 0
    callsign: Optional[str] = None
    altitude_ft: Optional[float] = None
    squawk: Optional[str] = None
    cpr: Optional[tuple] = None         # (odd_flag, lat_cpr, lon_cpr)
    ground_speed_kt: Optional[float] = None
    track_deg: Optional[float] = None
    vertical_rate_fpm: Optional[float] = None
    crc_ok: bool = False
    icao_derived: bool = False          # ICAO recovered from the AP overlay, not
    #                                     CRC-verified (DF4/5/20/21)


def _ac13_feet(f: np.ndarray) -> Optional[float]:
    """13-bit Mode S altitude code (AC) → feet. Q=1: 25 ft LSB grid; M (metric)
    and Q=0 Gillham codings are rare — return None rather than guess."""
    if int(f[6]):                        # M bit: metric altitude, not decoded
        return None
    if not int(f[8]):                    # Q=0: 100 ft Gillham gray code
        return None
    n = _bits_to_int(np.concatenate([f[:6], f[7:8], f[9:]]))
    return n * 25 - 1000


def _id13_squawk(f: np.ndarray) -> str:
    """13-bit identity code (Gillham order C1 A1 C2 A2 C4 A4 X B1 D1 B2 D2 B4 D4)
    → 4-digit squawk string."""
    c1, a1, c2, a2, c4, a4, _, b1, d1, b2, d2, b4, d4 = (int(b) for b in f)
    a = a4 * 4 + a2 * 2 + a1
    b = b4 * 4 + b2 * 2 + b1
    c = c4 * 4 + c2 * 2 + c1
    d = d4 * 4 + d2 * 2 + d1
    return f"{a}{b}{c}{d}"


def decode_frame(bits: np.ndarray) -> Optional[AdsbMessage]:
    """Decode Mode S downlink frames: DF17/18 extended squitter (identification,
    CPR position, velocity), DF11 all-call (acquisition), and the surveillance
    replies DF4/20 (altitude) / DF5/21 (identity) whose ICAO rides the AP parity
    overlay (address ⊕ parity ⇒ the CRC remainder IS the address)."""
    if len(bits) < 56:
        return None
    df = _bits_to_int(bits[0:5])
    if df in (4, 5, 20, 21):
        nb = 112 if df in (20, 21) else 56
        if len(bits) < nb:
            return None
        # crc_ok stays False: no parity check can run when the AP field is the
        # parity ⊕ address overlay — consumers gate these via icao_derived
        msg = AdsbMessage(df=df, icao=crc24(bits[:nb]), icao_derived=True)
        field = bits[19:32]
        if df in (4, 20):
            msg.altitude_ft = _ac13_feet(field)
        else:
            msg.squawk = _id13_squawk(field)
        return msg
    if df == 11:
        # acquisition squitter: PI = parity (remainder 0); an interrogator-
        # addressed reply leaves the 7-bit IC in the low remainder bits
        rem = crc24(bits[:56])
        return AdsbMessage(df=df, icao=_bits_to_int(bits[8:32]),
                           crc_ok=(rem & ~0x7F) == 0)
    if df not in (17, 18) or len(bits) < 112:
        icao = _bits_to_int(bits[8:32]) if len(bits) >= 32 else 0
        return AdsbMessage(df=df, icao=icao, crc_ok=False)
    msg = AdsbMessage(df=df, icao=_bits_to_int(bits[8:32]))
    msg.crc_ok = crc24(bits[:112]) == 0
    me = bits[32:88]
    tc = _bits_to_int(me[0:5])
    msg.type_code = tc
    if 1 <= tc <= 4:                     # aircraft identification
        chars = [_CALLSIGN_CHARS[_bits_to_int(me[8 + 6 * i:14 + 6 * i])]
                 for i in range(8)]
        msg.callsign = "".join(chars).replace("#", "").strip()
    elif 9 <= tc <= 18:                  # airborne position (baro altitude)
        alt_bits = me[8:20]
        q = alt_bits[7]
        if q:
            n = _bits_to_int(np.concatenate([alt_bits[:7], alt_bits[8:]]))
            msg.altitude_ft = n * 25 - 1000
        odd = int(me[21])
        lat = _bits_to_int(me[22:39])
        lon = _bits_to_int(me[39:56])
        msg.cpr = (odd, lat, lon)
    elif tc == 19:                       # airborne velocity (subtype 1: ground speed)
        subtype = _bits_to_int(me[5:8])
        if subtype in (1, 2):
            s_ew = int(me[13])
            v_ew = _bits_to_int(me[14:24]) - 1
            s_ns = int(me[24])
            v_ns = _bits_to_int(me[25:35]) - 1
            if v_ew >= 0 and v_ns >= 0:
                vx = -v_ew if s_ew else v_ew
                vy = -v_ns if s_ns else v_ns
                msg.ground_speed_kt = math.hypot(vx, vy)
                msg.track_deg = (math.degrees(math.atan2(vx, vy))) % 360
            s_vr = int(me[36])
            vr = _bits_to_int(me[37:46]) - 1
            if vr >= 0:
                msg.vertical_rate_fpm = (-vr if s_vr else vr) * 64
    return msg


def _cpr_nl(lat: float) -> int:
    # ICAO Annex 10 Vol III longitude-zone table edge cases: NL=59 at the equator,
    # NL=2 at exactly ±87°, NL=1 beyond
    alat = abs(lat)
    if alat == 0.0:
        return 59
    if alat == 87.0:
        return 2
    if alat > 87.0:
        return 1
    a = 1 - math.cos(math.pi / (2 * 15))
    b = math.cos(math.pi / 180.0 * alat) ** 2
    nl = math.floor(2 * math.pi / math.acos(1 - a / b))
    return max(1, int(nl))


def cpr_global_decode(even: tuple, odd: tuple, most_recent_odd: bool = True):
    """Globally-unambiguous position from an even/odd CPR pair (ICAO Annex 10 algo)."""
    _, lat_e, lon_e = even
    _, lat_o, lon_o = odd
    dlat_e = 360.0 / 60
    dlat_o = 360.0 / 59
    yz_e = lat_e / 131072.0
    yz_o = lat_o / 131072.0
    j = math.floor(59 * yz_e - 60 * yz_o + 0.5)
    lat_even = dlat_e * ((j % 60) + yz_e)
    lat_odd = dlat_o * ((j % 59) + yz_o)
    if lat_even >= 270:
        lat_even -= 360
    if lat_odd >= 270:
        lat_odd -= 360
    if _cpr_nl(lat_even) != _cpr_nl(lat_odd):
        return None
    lat = lat_odd if most_recent_odd else lat_even
    nl = _cpr_nl(lat)
    if most_recent_odd:
        ni = max(nl - 1, 1)
        dlon = 360.0 / ni
        xz = lon_o / 131072.0
        m = math.floor((lon_e / 131072.0) * (nl - 1) - (lon_o / 131072.0) * nl + 0.5)
        lon = dlon * ((m % ni) + xz)
    else:
        ni = max(nl, 1)
        dlon = 360.0 / ni
        xz = lon_e / 131072.0
        m = math.floor((lon_e / 131072.0) * (nl - 1) - (lon_o / 131072.0) * nl + 0.5)
        lon = dlon * ((m % ni) + xz)
    if lon >= 180:
        lon -= 360
    return lat, lon


def _dist_nm(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """Great-circle distance in nautical miles (haversine)."""
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * 3440.065 * math.asin(min(1.0, math.sqrt(a)))


def cpr_local_decode(cpr: tuple, ref_lat: float, ref_lon: float):
    """Locally-unambiguous position from a SINGLE CPR message plus a reference
    position within 180 NM (the standard receiver-site-aided decode): the
    reference selects the CPR zone, the message supplies the in-zone fraction.
    """
    odd, lat_cpr, lon_cpr = cpr
    yz = lat_cpr / 131072.0
    dlat = 360.0 / (59 if odd else 60)
    j = math.floor(ref_lat / dlat) + math.floor(
        0.5 + (ref_lat % dlat) / dlat - yz)
    lat = dlat * (j + yz)
    nl = _cpr_nl(lat)
    ni = max(nl - (1 if odd else 0), 1)
    dlon = 360.0 / ni
    xz = lon_cpr / 131072.0
    m = math.floor(ref_lon / dlon) + math.floor(
        0.5 + (ref_lon % dlon) / dlon - xz)
    lon = dlon * (m + xz)
    return lat, ((lon + 180.0) % 360.0) - 180.0   # same [-180, 180) as global


@dataclass
class Aircraft:
    icao: int
    callsign: Optional[str] = None
    squawk: Optional[str] = None
    altitude_ft: Optional[float] = None
    lat: Optional[float] = None
    lon: Optional[float] = None
    ground_speed_kt: Optional[float] = None
    track_deg: Optional[float] = None
    vertical_rate_fpm: Optional[float] = None
    last_seen: float = 0.0
    n_messages: int = 0
    _cpr_even: Optional[tuple] = None
    _cpr_odd: Optional[tuple] = None


class Tracker:
    """Aircraft registry fed by decoded messages (`tracker.rs` role)."""

    def __init__(self, timeout_s: float = 60.0,
                 ref_pos: Optional[tuple] = None):
        self.aircraft: Dict[int, Aircraft] = {}
        self.timeout = timeout_s
        # receiver site (lat, lon): enables single-message local CPR decode
        self.ref_pos = ref_pos

    def update(self, msg: AdsbMessage, now: Optional[float] = None) -> Optional[Aircraft]:
        if not msg.crc_ok and not msg.icao_derived:
            return None
        now = time.monotonic() if now is None else now
        if msg.icao_derived and msg.icao not in self.aircraft:
            # AP-overlay addresses are not CRC-verified: only update aircraft
            # already acquired via a checked frame (DF11/17/18), never create
            return None
        ac = self.aircraft.setdefault(msg.icao, Aircraft(icao=msg.icao))
        ac.last_seen = now
        ac.n_messages += 1
        if msg.callsign:
            ac.callsign = msg.callsign
        if msg.squawk is not None:
            ac.squawk = msg.squawk
        if msg.altitude_ft is not None:
            ac.altitude_ft = msg.altitude_ft
        if msg.ground_speed_kt is not None:
            ac.ground_speed_kt = msg.ground_speed_kt
            ac.track_deg = msg.track_deg
            ac.vertical_rate_fpm = msg.vertical_rate_fpm
        if msg.cpr is not None:
            odd, _, _ = msg.cpr
            if odd:
                ac._cpr_odd = msg.cpr
            else:
                ac._cpr_even = msg.cpr
            pos = None
            if ac._cpr_even and ac._cpr_odd:
                pos = cpr_global_decode(ac._cpr_even, ac._cpr_odd, bool(odd))
            if pos is None and self.ref_pos is not None:
                # local decode is unambiguous only within ~half a zone of the
                # site: range-check before accepting (as real decoders do)
                cand = cpr_local_decode(msg.cpr, *self.ref_pos)
                if _dist_nm(*cand, *self.ref_pos) < 180.0:
                    pos = cand
            if pos is not None:
                ac.lat, ac.lon = pos
        self._expire(now)
        return ac

    def _expire(self, now: float):
        dead = [k for k, a in self.aircraft.items() if now - a.last_seen > self.timeout]
        for k in dead:
            del self.aircraft[k]
