"""render_rays_per_s: the rays of every view completed in the measured
window over the window's wall (host clock, each view synchronised)."""


def read(ctx):
    if ctx.cell.traffic["loop"] != "render" or not ctx.window.units:
        return None
    return ctx.window.rays / ctx.window.seconds
