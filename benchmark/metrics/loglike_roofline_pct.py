"""loglike_roofline_pct: the exact path's fused loglike (``fused_loglike``:
the split of aug(x) and the split GEMM), counted as one f32 product of
N x F by F x C (``flops/gmm.py``: ``loglike``) per GEMM launch, over the
two kernels' device time."""

from benchmark.flops import gmm
from benchmark.readers import bound_and_time, roofline_pct

KERNELS = ("aug_split_kernel", "loglike_split_gemm_kernel")


def read(ctx):
    return roofline_pct(bound_and_time(ctx, KERNELS, gmm.loglike,
                                       "loglike_split_gemm_kernel"))
