"""mfu.render: the whole render's share of the card's f32 peak, in %:
the configuration's forward FLOPs a sample times the samples composited
in the checked views (counted by the reference, which marches the same
rays on the same grid and weights), over the window's mean wall of a
view of the same poses, and 67 TFLOP/s."""
import statistics

from benchmark.harness import roofline


def read(ctx):
    if ctx.cell.traffic["loop"] != "render" or not ctx.reference:
        return None
    pose_s = ctx.run.pose_s
    samples = sum(n for _, _, n in ctx.reference)
    seconds = sum(statistics.mean(pose_s[p]) for p, _, _ in ctx.reference)
    if not samples or not seconds:
        return None
    flops = roofline.field_flops(ctx.grid) * samples
    return 100.0 * flops / seconds / roofline.F32_FLOP_PER_S
