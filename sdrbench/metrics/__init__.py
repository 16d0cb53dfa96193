"""Metric readers: ``<metric>.py`` has ``read(run)``, the value or None."""
