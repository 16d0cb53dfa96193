"""Models: the counterpart of ``futuresdr_tpu/models``.

The WLAN 802.11a/g transceiver (:mod:`.wlan`), the MCLDNN modulation
classifier (:mod:`.mcldnn`, :mod:`.modrec`), M17's trellis
(:mod:`.m17`) and the LoRa transceiver (:mod:`.lora`). Names resolve lazily, so that importing one model does not
import the others.
"""

__all__ = ["MCLDNN", "loss_fn", "wlan", "mcldnn", "modrec", "m17", "lora"]

_ML_NAMES = {"MCLDNN", "loss_fn"}
_SUBMODULES = {"wlan", "mcldnn", "modrec", "m17", "lora"}


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
