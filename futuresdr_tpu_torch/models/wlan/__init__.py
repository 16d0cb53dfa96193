"""IEEE 802.11a/g/p OFDM transceiver: the counterpart of ``futuresdr_tpu/models/wlan``.

The reference's largest example (``examples/wlan/``, a port of gr-ieee802-11): TX
(scramble/convolutional-code/interleave/map/IFFT+CP/preamble, host numpy) and RX
(detect/sync on the host; equalize/demap on the device; Viterbi on the host per frame
or batched on the device; descramble) with MAC framing.
"""

from .consts import MCS_TABLE, Mcs
from .phy import (encode_frame, decode_frame, decode_stream, decode_stream_batch,
                  DecodedFrame)
from .mac import Mac, mpdu_from_payload, payload_from_mpdu
from .blocks import WlanEncoder, WlanDecoder
from .channels import channel_to_freq, freq_to_channel, parse_channel
from . import coding, ofdm, torch_demod

__all__ = ["MCS_TABLE", "Mcs", "encode_frame", "decode_frame", "decode_stream",
           "decode_stream_batch", "DecodedFrame", "Mac", "mpdu_from_payload",
           "payload_from_mpdu", "WlanEncoder", "WlanDecoder", "coding", "ofdm",
           "torch_demod", "channel_to_freq", "freq_to_channel", "parse_channel"]
