"""The benchmark's plain PyTorch reference of stage-1 training and
rendering: a frozen copy of the port's plain paths that imports nothing
of the port or of JAX."""
