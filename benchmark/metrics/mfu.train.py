"""mfu.train: the whole training step's share of the card's f32 peak,
in %: the configuration's FLOPs a sample (interpolation and both MLPs,
x3 for the backward) times the samples composited in the measured
window (each step's `aux["num_valid"]`, at most the budget; a program
counter), over the window's wall and 67 TFLOP/s."""
from benchmark.harness import roofline


def read(ctx):
    w = ctx.window
    if ctx.cell.traffic["loop"] != "train" or not w.samples:
        return None
    flops = roofline.train_flops(ctx.grid) * w.samples
    return 100.0 * flops / w.seconds / roofline.F32_FLOP_PER_S
