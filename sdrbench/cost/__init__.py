"""The least work of a frame, one file a configuration: ``frame(config, n)``."""
