"""gmm_stats_roofline_pct: the fused statistics kernels, ``stats_fwd``
(aug16, loglike GEMM, normalise) and ``stats_bwd`` (dl, daug GEMM, chain
rule): the bound of their work (``flops/gmm.py``, once per launch of each
GEMM) over their summed device time."""

from benchmark.flops import gmm
from benchmark.readers import bound_and_time, roofline_pct

FWD = ("aug16_kernel", "loglike_gemm_kernel", "normalise_stats_kernel")
BWD = ("dl_direct_kernel", "daug_gemm_kernel", "chain_sum_kernel")


def read(ctx):
    return roofline_pct(
        bound_and_time(ctx, FWD, gmm.stats_fwd, "loglike_gemm_kernel"),
        bound_and_time(ctx, BWD, gmm.stats_bwd, "daug_gemm_kernel"))
