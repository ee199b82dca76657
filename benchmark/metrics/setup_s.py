"""setup_s: from the start of the run's process to the start of the
window: imports, the CUDA context, the kernels' build or load, the
views, the weights, and the warm-up steps or views (host clock)."""


def read(ctx):
    return ctx.setup_s
