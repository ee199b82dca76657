"""table_grad_roofline.train: the fused table gradient's least time (the
positions and the cotangent read once, each touched gradient row
written once, on the shapes of its launches in the traced slice) over
its device time, in %: K1 (`encode_bwd_kernel`) on the corner layout,
K7 (`cell_grad_x_kernel`) on the cell layout."""
from benchmark.harness import roofline

KERNELS = ("encode_bwd_kernel", "cell_grad_x_kernel")


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.cell.traffic["loop"] != "train":
        return None
    shapes = ctx.run.call_log.shapes("table_grad", ctx.grid)
    busy = sl.time_of(KERNELS)
    if not shapes or busy <= 0:
        return None
    least = sum(roofline.table_grad_least_s(ctx.grid, n, r)
                for n, r in shapes)
    return 100.0 * least / busy
