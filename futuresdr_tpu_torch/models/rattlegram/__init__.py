"""Rattlegram-role audio OFDM modem: waveform modem + the real aicodix FEC family.

``modem``: the 8 kHz OFDM burst modem (MLS sync, QPSK carriers).
``fec``: BCH(255,71) + CRC16/32 + MLS/xorshift + order-2 OSD (preamble metadata path).
``polar``: systematic polar(2048) + CRC32-aided list-32 SCL decoding (payload path).

The port's copy of ``futuresdr_tpu/models/rattlegram``: host numpy, its float32
FFTs unchanged, driven by the port's runtime.
"""

from .modem import (Modem, ModemParams, ModemReceiver, ModemTransmitter, demodulate,
                    demodulate_all, demodulate_auto, demodulate_all_auto, mls,
                    modulate)
from .fec import (BCH_K, BCH_N, bch_generator_matrix, bch_genpoly, bch_parity,
                  crc16_rattlegram, crc32_rattlegram, mls_bits, osd_decode, Xorshift32)
from .polar import (CODE_LEN, FROZEN_2048_712, FROZEN_2048_1056, FROZEN_2048_1392,
                    frozen_mask, polar_decode, polar_encode)

__all__ = ["Modem", "ModemParams", "ModemReceiver", "ModemTransmitter", "demodulate",
           "demodulate_all", "demodulate_auto", "demodulate_all_auto", "mls",
           "modulate",
           "BCH_K", "BCH_N", "bch_generator_matrix", "bch_genpoly", "bch_parity",
           "crc16_rattlegram", "crc32_rattlegram", "mls_bits", "osd_decode",
           "Xorshift32",
           "CODE_LEN", "FROZEN_2048_712", "FROZEN_2048_1056", "FROZEN_2048_1392",
           "frozen_mask", "polar_decode", "polar_encode"]
