"""Data of the port: ``datasets`` (a copy of mlcomp_tpu/data/datasets.py)
and ``loader`` (the DataLoader, ported)."""
