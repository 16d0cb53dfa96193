"""M17 digital radio protocol: the counterpart of ``futuresdr_tpu/models/m17``.

So far the port holds the K = 5 convolutional code's trellis tables
(:mod:`.codec`'s ``_M17_PREV``), which the device Viterbi decoder
(``ops/viterbi.py``) takes as its 16-state trellis.
"""
