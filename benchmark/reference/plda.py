"""Plain float32 back end shared by both speaker models: mean subtraction,
the LDA affine, length normalisation and Kaldi's two-covariance PLDA
(ivector-plda-scoring: TransformIvector, LogLikelihoodRatio with one
enrolment utterance), batched over test utterances and speakers."""

import math

import torch


def process(w: dict, emb: torch.Tensor) -> torch.Tensor:
    """(B, E) raw embedding -> (B, R) in the PLDA's transformed space."""
    x = emb - w["emb_mean"]
    lda = w["transform_mat"]
    x = x @ lda[:, :-1].T + lda[:, -1]
    r = x.shape[-1]
    x = x * (math.sqrt(r) / torch.clamp(x.norm(dim=-1, keepdim=True),
                                        min=1e-12))
    x = (x - w["plda_mean"]) @ w["plda_transform"].T
    psi = w["plda_psi"]
    # TransformIvector with normalize_length, one example: the expected
    # squared length under the model is r
    norm = torch.sum(x * x / (psi + 1.0), dim=-1, keepdim=True)
    return x * torch.sqrt(r / norm)


def llr(w: dict, enroll: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """(S, R) enrolled speakers, (B, R) tests -> (B, S) log-likelihood
    ratios of "same speaker" against "different speakers"."""
    psi = w["plda_psi"]
    r = psi.shape[0]
    mean = enroll * (psi / (psi + 1.0))
    var_same = 1.0 + psi / (psi + 1.0)
    var_diff = 1.0 + psi
    ll_same = -0.5 * (torch.log(var_same).sum() + r * math.log(2 * math.pi)
                      + (((test[:, None, :] - mean[None]) ** 2) / var_same)
                      .sum(-1))
    ll_diff = -0.5 * (torch.log(var_diff).sum() + r * math.log(2 * math.pi)
                      + ((test ** 2) / var_diff).sum(-1))
    return ll_same - ll_diff[:, None]
