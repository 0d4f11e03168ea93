"""See the package docstring in wis_tpu_torch/__init__.py."""
