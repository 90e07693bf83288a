"""ecapa_conv_roofline_pct: the TDNN block kernel (ops/tdnn_conv.py,
csrc/tdnn_conv.cu) in the ECAPA-TDNN cell, both directions.  A direction's
bound a call is ``max_iter`` times the sum over ECAPA's 30 blocks of the
bound of one block's work (``flops/ecapa_tdnn.blocks``) against the peaks
of ``flops/peaks.py``; its time is the summed device time of its kernel's
launches.  A direction whose kernel did not run once a block an iteration
of each traced call leaves the metric out: it never divides a whole
call's bound by part of the work."""

from benchmark.flops import ecapa_tdnn, peaks
from benchmark.readers import frames, kernel_name

KERNELS = ("tdnn_conv_fwd_kernel", "tdnn_conv_bwd_kernel")


def read(ctx):
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    iters = traffic["attack"]["max_iter"]
    work = ecapa_tdnn.blocks(cfg, traffic["batch"], frames(ctx.cell))
    per_call = iters * sum(peaks.bound_s(ops, nbytes) for ops, nbytes in work)
    launches = len(work) * iters * ctx.calls
    bound = seconds = 0.0
    for name in KERNELS:
        sel = [e for e in ctx.trace.kernels if kernel_name(e.name) == name]
        if len(sel) != launches:
            return None
        bound += per_call * ctx.calls
        seconds += sum(e.end - e.start for e in sel) * 1e-9
    return 100.0 * bound / seconds
