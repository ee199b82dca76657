"""Port of quadraturefields_tpu.utils."""
