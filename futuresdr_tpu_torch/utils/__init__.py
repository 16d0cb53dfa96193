"""Helpers shared across the port's planes (``snapshot``: the carry
checkpoints persisted on disk)."""
