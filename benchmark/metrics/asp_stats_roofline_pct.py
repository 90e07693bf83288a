"""asp_stats_roofline_pct: the attentive statistics' kernel
(ops/asp_pool.py, csrc/asp_pool.cu) in the ECAPA-TDNN cell, both
directions.  A call's bound is ``max_iter`` times the bound of one
forward's and one backward's work (``flops/ecapa_tdnn.pool_fwd``,
``pool_bwd``: bytes bind) against the peaks of ``flops/peaks.py``; the
time is the summed device time of the two kernels' launches.  A direction
whose kernel did not run once an iteration of each traced call leaves the
metric out."""

from benchmark.flops import ecapa_tdnn, peaks
from benchmark.readers import frames, kernel_name

KERNELS = {"asp_stats_fwd_kernel": ecapa_tdnn.pool_fwd,
           "asp_stats_bwd_kernel": ecapa_tdnn.pool_bwd}


def read(ctx):
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    iters = traffic["attack"]["max_iter"]
    launches = iters * ctx.calls
    bound = seconds = 0.0
    for name, counter in KERNELS.items():
        sel = [e for e in ctx.trace.kernels if kernel_name(e.name) == name]
        if len(sel) != launches:
            return None
        ops, nbytes = counter(cfg, traffic["batch"], frames(ctx.cell))
        bound += launches * peaks.bound_s(ops, nbytes)
        seconds += sum(e.end - e.start for e in sel) * 1e-9
    return 100.0 * bound / seconds
