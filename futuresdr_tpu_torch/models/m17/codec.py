"""M17 codecs: the K = 5 convolutional code's trellis.

The port's copy of the trellis tables of ``futuresdr_tpu/models/m17/codec.py``
(the M17 spec §2.4.2: polynomials 0x19 / 0x17, 16 states): each next state's
two predecessor states and input bits, and their branch output bits in ±1,
the tables ``viterbi_decode_m17`` hands the device decoder
(``ops/viterbi.scan_viterbi``) for frames of 512 steps or more.
"""

from __future__ import annotations

import numpy as np

__all__: list = []

# ---- K=5 convolutional code, polys 0x19 / 0x17 (M17 spec §2.4.2) ---------------------
_G1, _G2 = 0x19, 0x17
_NS = 16

_OUT = np.zeros((_NS, 2, 2), dtype=np.uint8)
_NXT = np.zeros((_NS, 2), dtype=np.int64)
for s in range(_NS):
    for b in range(2):
        reg = (b << 4) | s
        _OUT[s, b, 0] = bin(reg & _G1).count("1") & 1
        _OUT[s, b, 1] = bin(reg & _G2).count("1") & 1
        _NXT[s, b] = reg >> 1


def _m17_prev_tables():
    prev_tbl = [[] for _ in range(_NS)]
    for s in range(_NS):
        for b in range(2):
            prev_tbl[_NXT[s, b]].append((s, b))
    prev_s = np.array([[p[0][0], p[1][0]] for p in prev_tbl])
    prev_b = np.array([[p[0][1], p[1][1]] for p in prev_tbl])
    o = _OUT.astype(np.float64) * 2 - 1
    return prev_s, prev_b, o[prev_s, prev_b, 0], o[prev_s, prev_b, 1]


#: ``(prev_s, prev_b, bm0, bm1)``, each ``[16, 2]``
_M17_PREV = _m17_prev_tables()
