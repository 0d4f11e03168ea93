"""The port's version (``wis_tpu/version.py``'s counterpart)."""

__version__ = "0.1.0"
