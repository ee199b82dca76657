"""launches_per_view.render: kernels on the card in the traced slice
over its views (device trace)."""


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.cell.traffic["loop"] != "render" or not sl.kernels:
        return None
    return len(sl.kernels) / sl.units
