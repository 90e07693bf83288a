"""attack_mfu_pct: the model's operations in the traced whole attack calls,
counted from the mathematics at the cell's shapes
(``flops/<model>.py``: ``attack``), over the stretch's time, against the
card's dense bf16 peak (``flops/peaks.py``)."""

from benchmark import harness
from benchmark.flops import peaks


def read(ctx):
    t = ctx.trace
    if not t.device_events():
        return None
    cfg = ctx.cell.config
    ops = harness.part("flops", cfg["model"]).attack(cfg, ctx.cell.traffic)
    return 100.0 * ops * ctx.calls / (t.window_s * peaks.FLOPS)
