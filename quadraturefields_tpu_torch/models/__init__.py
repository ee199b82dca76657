"""Port of quadraturefields_tpu.models."""
