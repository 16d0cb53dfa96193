"""M17 digital radio protocol (reference: ``examples/m17/``): base-40 callsigns,
Golay(24,12), CRC16, K=5 convolutional code, LSF framing, 4FSK RRC PHY.

The port's copy of ``futuresdr_tpu/models/m17``, host numpy as in the
reference and driven by the port's runtime. Its one device path is the
Viterbi decoder's: ``codec.viterbi_decode_m17`` sends a frame of 512 steps
or more to ``ops/viterbi.scan_viterbi`` (the hand kernel ``csrc/viterbi.cu``
on a card) with the K = 5 code's 16-state trellis (``codec._M17_PREV``).
"""

from .codec import (encode_callsign, decode_callsign, crc16_m17, golay24_encode,
                    golay24_decode, conv_encode_m17, viterbi_decode_m17)
from .phy import (Lsf, build_lsf_frame, build_stream_frames, modulate,
                  demodulate_stream, demodulate_payload_stream, SYNC_LSF,
                  SYNC_STR)
from .blocks import M17Transmitter, M17Receiver

__all__ = ["encode_callsign", "decode_callsign", "crc16_m17", "golay24_encode",
           "golay24_decode", "conv_encode_m17", "viterbi_decode_m17",
           "Lsf", "build_lsf_frame", "build_stream_frames", "modulate",
           "demodulate_stream", "demodulate_payload_stream", "SYNC_LSF",
           "SYNC_STR", "M17Transmitter", "M17Receiver"]
