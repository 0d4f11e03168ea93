"""XTTS v2 streaming text-to-speech (port of ``wis_tpu/models/xtts``)."""
