"""Ray-batch data parallelism over torch.distributed ranks (dp.py) and
the process group's set-up and batch slicing (multihost.py)."""
