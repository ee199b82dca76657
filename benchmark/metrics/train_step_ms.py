"""train_step_ms: the measured window's wall over the training steps
completed in it (host clock; the window ends when its last step has
finished on the card)."""


def read(ctx):
    if ctx.cell.traffic["loop"] != "train" or not ctx.window.units:
        return None
    return 1e3 * ctx.window.seconds / ctx.window.units
