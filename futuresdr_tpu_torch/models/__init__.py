"""Models: the counterpart of ``futuresdr_tpu/models``.

The WLAN 802.11a/g transceiver (:mod:`.wlan`), the MCLDNN modulation
classifier (:mod:`.mcldnn`, :mod:`.modrec`), the LoRa transceiver
(:mod:`.lora`), M17 (:mod:`.m17`, whose long frames decode on the device's
Viterbi kernel), ZigBee (:mod:`.zigbee`), ADS-B (:mod:`.adsb`), the
Rattlegram audio modem (:mod:`.rattlegram`) and the CW, SSB and OOK
transceivers (:mod:`.misc`). Names resolve lazily, so that importing one
model does not import the others.
"""

__all__ = ["MCLDNN", "loss_fn", "wlan", "lora", "zigbee", "m17", "adsb", "mcldnn",
           "modrec", "misc", "rattlegram"]

_ML_NAMES = {"MCLDNN", "loss_fn"}
_SUBMODULES = {"wlan", "lora", "zigbee", "m17", "adsb", "mcldnn", "modrec", "misc",
               "rattlegram"}


def __getattr__(name):
    import importlib
    if name in _ML_NAMES:
        mod = importlib.import_module(".mcldnn", __name__)
        val = getattr(mod, name)
        globals()[name] = val
        return val
    if name in _SUBMODULES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
