"""Runnable applications: the port's counterparts of ``futuresdr_tpu/apps``."""
