"""Plain references, one a configuration: ``expected``, ``compare``, ``LIMITS``."""
