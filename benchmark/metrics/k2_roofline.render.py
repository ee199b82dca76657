"""k2_roofline.render: K2's least time (bytes read once and written once
on the shapes of its launches in the traced slice: the positions, each
touched table row, the features) over its device time, in %."""
from benchmark.harness import roofline

K2 = ("encode_tet_kernel", "encode_cube_kernel")


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.cell.traffic["loop"] != "render":
        return None
    shapes = ctx.run.call_log.shapes("encode", ctx.grid)
    busy = sl.time_of(K2)
    if not shapes or busy <= 0:
        return None
    least = sum(roofline.encode_least_s(ctx.grid, n, r) for n, r in shapes)
    return 100.0 * least / busy
