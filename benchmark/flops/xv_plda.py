"""Operations of xv-PLDA at a cell's shapes, counted from the mathematics
once: the front end (``frontend.py``), each dilated convolution as
2 B T_out (C_in k) C_out, the first affine layer, the LDA and the PLDA.
An attack's input gradient computes each product's transpose once, the
same count again; no weight gradient is taken."""

from benchmark.flops import frontend


def forward(cfg: dict, batch: int, samples: int) -> float:
    t, _, _ = frontend.frames(cfg, samples)
    ops = frontend.forward(cfg, batch, samples)
    c_in = cfg["frontend"]["num_ceps"]
    for k, dil, c_out in cfg["tdnn"]:
        t -= (k - 1) * dil
        ops += 2.0 * batch * t * c_in * k * c_out
        c_in = c_out
    emb, lda = cfg["embedding_dim"], cfg["lda_dim"]
    ops += 2.0 * batch * (2 * c_in * emb + emb * lda + lda * lda
                          + 3 * cfg["enrolled_speakers"] * lda)
    return ops


def attack(cfg: dict, traffic: dict) -> float:
    """One whole PGD call: each iteration a forward and an input gradient,
    then the final evaluation."""
    b, n = traffic["batch"], traffic["samples"]
    f = forward(cfg, b, n)
    return traffic["attack"]["max_iter"] * 2.0 * f + f
