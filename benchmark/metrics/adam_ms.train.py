"""adam_ms.train: device time of the optimizer's kernels (those launched
inside `Optimizer.step`) a training step of the traced slice, in ms
(device trace)."""


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.cell.traffic["loop"] != "train" or not sl.optimizer:
        return None
    return 1e3 * sl.optimizer_s() / sl.units
