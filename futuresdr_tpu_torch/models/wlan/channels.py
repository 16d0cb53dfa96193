"""WLAN channel-number ↔ center-frequency table (reference `channels.rs:1-87`);
the port's copy of ``futuresdr_tpu/models/wlan/channels.py``.

The 67 channels of the reference's lookup: 802.11g (2.4 GHz, 1-14), 802.11a
(5 GHz UNII bands), and 802.11p (5.9 GHz ITS). Same API shape:
``channel_to_freq`` returns None for unknown channels; ``parse_channel``
raises ValueError with the reference's message semantics (bad int OR unknown
channel); plus the reverse lookup the GUI retune panel wants.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["CHANNELS", "channel_to_freq", "freq_to_channel", "parse_channel"]

CHANNELS: dict = {
    # 11g (2.4 GHz)
    **{c: 2412e6 + 5e6 * (c - 1) for c in range(1, 14)}, 14: 2484e6,
    # 11a (5 GHz)
    **{c: 5000e6 + 5e6 * c for c in (34, 36, 38, 40, 42, 44, 46, 48, 50, 52,
                                     54, 56, 58, 60, 62, 64,
                                     100, 102, 104, 106, 108, 110, 112, 114,
                                     116, 118, 120, 122, 124, 126, 128, 132,
                                     134, 136, 138, 140, 142, 144,
                                     149, 151, 153, 155, 157, 159, 161, 165)},
    # 11p (5.9 GHz ITS)
    **{c: 5000e6 + 5e6 * c for c in (172, 174, 176, 178, 180, 182, 184)},
}


def channel_to_freq(chan: int) -> Optional[float]:
    """Center frequency in Hz, or None for an unknown channel (`channels.rs:74`)."""
    return CHANNELS.get(int(chan))


def freq_to_channel(freq_hz: float) -> Optional[int]:
    """Reverse lookup (exact match), e.g. for display beside a retuned source."""
    for c, f in CHANNELS.items():
        if f == freq_hz:
            return c
    return None


def parse_channel(s: str) -> float:
    """CLI parse: channel-number string → frequency (`channels.rs:80-87`)."""
    try:
        chan = int(s)
    except (TypeError, ValueError):
        raise ValueError(f"`{s}` isn't a WLAN channel number") from None
    f = channel_to_freq(chan)
    if f is None:
        raise ValueError(f"`{s}` isn't a WLAN channel number")
    return f
