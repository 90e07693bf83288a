"""Operations of iv-PLDA at a cell's shapes, counted from the mathematics
once, with F = D + D (D+1) / 2 the linear and distinct quadratic terms of
a frame and P = IV (IV+1) / 2 the distinct entries of the symmetric L:

    front end                ``frontend.py`` (deltas and CMN elementwise)
    component loglikes       2 N F C            (N = B T frames)
    first-order statistics   2 N C D
    L = I + sum_c N_c Q_c    2 B C P
    linear term              2 B C D IV
    Cholesky of L            2 B IV^3 / 3, two triangular solves 2 B IV^2
    LDA and PLDA             as products

C is the components the path scores: all of them on the exact path, the
frozen top K on the fast path's iterations where the mix selects them
(one full pass on the clean input chooses them).  The input gradient
computes the transposed products once (the loglikes', both of the
statistics' terms, L's and the linear term's) and solves with the
forward's factor."""

from benchmark.flops import frontend


def _dims(cfg):
    d = 3 * cfg["frontend"]["num_ceps"]
    iv = cfg["ivector_dim"]
    return d, d + d * (d + 1) // 2, iv, iv * (iv + 1) // 2


def forward(cfg: dict, batch: int, samples: int, comps: int) -> float:
    t, _, _ = frontend.frames(cfg, samples)
    n = batch * t
    d, f, iv, p = _dims(cfg)
    r = cfg["plda_dim"]
    ops = frontend.forward(cfg, batch, samples)
    ops += 2.0 * n * comps * (f + d)
    ops += 2.0 * batch * comps * (p + d * iv)
    ops += 2.0 * batch * iv ** 3 / 3.0 + 2.0 * batch * iv ** 2
    ops += 2.0 * batch * (iv * r + r * r + 3 * cfg["enrolled_speakers"] * r)
    return ops


def input_gradient(cfg: dict, batch: int, samples: int, comps: int) -> float:
    t, _, _ = frontend.frames(cfg, samples)
    n = batch * t
    d, f, iv, p = _dims(cfg)
    ops = frontend.forward(cfg, batch, samples)
    ops += 2.0 * n * comps * (f + 2 * d)
    ops += 2.0 * batch * comps * (p + d * iv) + 2.0 * batch * iv ** 2
    return ops


def attack(cfg: dict, traffic: dict) -> float:
    """One whole PGD call: the top-K choice where the path selects, each
    iteration a forward and an input gradient at the path's components,
    then the exact final evaluation at all of them."""
    b, n = traffic["batch"], traffic["samples"]
    c = cfg["ubm_components"]
    top_k = traffic["program"]["fast_path"].get("gmm_topk", 0)
    k = top_k if 0 < top_k < c else c
    ops = 0.0
    if k < c:
        t, _, _ = frontend.frames(cfg, n)
        _, f, _, _ = _dims(cfg)
        ops += frontend.forward(cfg, b, n) + 2.0 * b * t * c * f
    it = forward(cfg, b, n, k) + input_gradient(cfg, b, n, k)
    return ops + traffic["attack"]["max_iter"] * it + forward(cfg, b, n, c)
