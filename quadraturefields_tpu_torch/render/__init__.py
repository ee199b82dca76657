"""Port of quadraturefields_tpu.render."""
