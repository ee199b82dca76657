"""Port of quadraturefields_tpu.train."""
