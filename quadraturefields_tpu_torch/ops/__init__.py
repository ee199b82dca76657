"""Port of quadraturefields_tpu.ops."""
