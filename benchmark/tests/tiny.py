"""The benchmark's cells cut to a size the CPU runs in seconds: few
levels and rows, a 2^13-sample budget, 32^2 training views (the checked
steps, as at the real size, start on the first occupancy refresh after
the warm-up, at step 256), and 24^2 test views in chunks of 64 rays on
the window renderer.
The cell layout takes K7's plain version (grad_mode "sorted"), which
the card's "auto" takes at the real size."""
from __future__ import annotations

import copy

from benchmark.harness import cells

WARM_STEPS = 256


def tiny_cell(name: str) -> cells.Cell:
    return shrink(cells.find_cell(name))


def shrink(cell: cells.Cell) -> cells.Cell:
    c = copy.deepcopy(cell)
    s = c.config["stage1"]
    s.update(n_levels=4, log2_hashmap_size=12, batch_size_log2=13,
             init_batch_size=256, eval_chunk=1024)
    if s["layout"] == "cell":
        s["grad_mode"] = "sorted"
    t = c.traffic
    if t["loop"] == "train":
        t["views"]["res"] = 32
        t.update(warm_steps=WARM_STEPS, trace_units=2)
    else:
        s.update(eval_renderer="window", eval_chunk=64)
        t["views"]["res"] = 24
        t.update(keep_views=1, checked_views=1)
    return c
