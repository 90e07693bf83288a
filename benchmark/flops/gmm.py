"""Operations and bytes of the GMM kernels at a launch's N = B T frames,
counted from their mathematics once, with no padding (F = D + D (D+1)/2
unpadded, C components):

stats_fwd   loglike = aug(x) proj + gconsts, softmax, zeroth, first:
            2 N F C + 2 N C D operations; reads x (f32), proj (bf16),
            gconsts, writes zeroth, first (f32) and the bf16 posteriors
            that the backward reads.
stats_bwd   dp = dz + x df', dl, daug = dl proj', the chain rule and
            posts df: 2 N C F + 4 N C D + 4 N (F - D) operations; reads x,
            the posteriors, dz, df and proj, writes dx.
loglike     the exact loglike, one product of N x F by F x C: 2 N F C
            operations; reads x and the f32 projection, writes the
            (N, C) loglikes.
"""


def _sizes(cfg):
    d = 3 * cfg["frontend"]["num_ceps"]
    return d, d + d * (d + 1) // 2, cfg["ubm_components"]


def stats_fwd(cfg: dict, batch: int, frames: int) -> tuple:
    d, f, c = _sizes(cfg)
    n = batch * frames
    ops = 2.0 * n * f * c + 2.0 * n * c * d
    nbytes = 4 * n * d + 2 * f * c + 4 * c + 4 * batch * c * (1 + d) \
        + 2 * n * c
    return ops, float(nbytes)


def stats_bwd(cfg: dict, batch: int, frames: int) -> tuple:
    d, f, c = _sizes(cfg)
    n = batch * frames
    ops = 2.0 * n * c * f + 4.0 * n * c * d + 4.0 * n * (f - d)
    nbytes = 4 * n * d + 2 * n * c + 4 * batch * c * (1 + d) + 2 * f * c \
        + 4 * n * d
    return ops, float(nbytes)


def loglike(cfg: dict, batch: int, frames: int) -> tuple:
    d, f, c = _sizes(cfg)
    n = batch * frames
    return 2.0 * n * f * c, float(4 * n * d + 4 * f * c + 4 * c + 4 * n * c)
