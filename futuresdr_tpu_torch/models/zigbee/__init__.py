"""IEEE 802.15.4 / ZigBee O-QPSK transceiver (reference: ``examples/zigbee/``).

The port's copy of ``futuresdr_tpu/models/zigbee``: host numpy, its arithmetic
(float32 where the reference's is) unchanged, driven by the port's runtime.
"""

from .phy import (CHIP_SEQUENCES, modulate_frame, demodulate_stream, mac_frame,
                  mac_deframe, crc16_802154)
from .blocks import IqDelay, ZigbeeTransmitter, ZigbeeReceiver

__all__ = ["CHIP_SEQUENCES", "modulate_frame", "demodulate_stream", "mac_frame",
           "mac_deframe", "crc16_802154", "IqDelay", "ZigbeeTransmitter",
           "ZigbeeReceiver"]
