"""device_idle_share.render: the share of the traced slice's wall in
which no operation ran on the card, in % (device trace)."""


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.cell.traffic["loop"] != "render" or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.wall_s)
