"""launches_per_step.train: kernels on the card in the traced slice
over its training steps (device trace)."""


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.cell.traffic["loop"] != "train" or not sl.kernels:
        return None
    return len(sl.kernels) / sl.units
