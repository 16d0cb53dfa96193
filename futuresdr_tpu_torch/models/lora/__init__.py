"""LoRa PHY transceiver (reference: ``examples/lora/``, port of gr-lora_sdr).

The port's copy of ``futuresdr_tpu/models/lora``: chirp-spread-spectrum
modulation with Hamming coding, diagonal interleaving, Gray mapping, whitening,
explicit header, CRC16, frame-level in numpy, driven by the port's runtime.
The arithmetic is the JAX package's: the same seed gives the same samples and
the same payloads.
"""

from .phy import (LoraParams, modulate_frame, demodulate_frame, detect_frames,
                  decode_symbols, encode_payload_symbols)
from .blocks import LoraTransmitter, LoraReceiver
from .forwarder import PacketForwarderClient, build_rxpk
from .multichannel import EU868_CHANNELS_HZ, build_multichannel_rx
from . import coding, meshtastic

__all__ = ["LoraParams", "modulate_frame", "demodulate_frame", "detect_frames",
           "decode_symbols", "encode_payload_symbols", "LoraTransmitter",
           "LoraReceiver", "PacketForwarderClient", "build_rxpk",
           "EU868_CHANNELS_HZ", "build_multichannel_rx", "coding", "meshtastic"]
