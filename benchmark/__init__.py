"""The H100 benchmark of quadraturefields_tpu_torch (run.py)."""
