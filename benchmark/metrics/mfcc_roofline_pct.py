"""mfcc_roofline_pct: the fast path's fused MFCC (ops/mfcc_fast.py,
csrc/mfcc.cu), both directions.  A direction's bound a launch is
``flops/mfcc.py``'s work against the peaks of ``flops/peaks.py``, over
``max_iter`` launches a call (one forward and one input gradient an
attack iteration); its time is the summed device time of its kernels'
launches: the forward's one, the input gradient's two (the gM kernel,
which also zeroes the gradient, then the main one).  A kernel that did
not run once an iteration of each traced call leaves the metric out: it
never divides a whole call's bound by part of the work.  The iv cells run
the forward once more a call, for the top-K context without dither, so
their traces hold more launches and read nothing."""

from benchmark.flops import mfcc, peaks
from benchmark.readers import kernel_name

KERNELS = {"fwd": ("mfcc_fwd_kernel",),
           "bwd": ("mfcc_bwd_gm_kernel", "mfcc_bwd_kernel")}


def read(ctx):
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    launches = traffic["attack"]["max_iter"] * ctx.calls
    bound = seconds = 0.0
    for direction, names in KERNELS.items():
        for name in names:
            sel = [e for e in ctx.trace.kernels
                   if kernel_name(e.name) == name]
            if len(sel) != launches:
                return None
            seconds += sum(e.end - e.start for e in sel) * 1e-9
        ops, nbytes = getattr(mfcc, direction)(cfg, traffic["batch"],
                                               traffic["samples"])
        bound += launches * peaks.bound_s(ops, nbytes)
    return 100.0 * bound / seconds
