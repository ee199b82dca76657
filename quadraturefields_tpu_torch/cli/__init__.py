"""Port of quadraturefields_tpu.cli."""
