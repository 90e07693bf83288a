"""iv-PLDA: raw weights from the seed, and the program built on them.

Drawn on the device in two calls (``draw``): a well-conditioned
full-covariance UBM (each inverse covariance A A' / 100 + I, means
standard normal, equal weights, Kaldi's gconsts from them), the total
variability matrix M and the extractor's inverse covariances, Kaldi's
prior offset, the LDA, the PLDA and the enrolled speakers' embeddings in
the PLDA space.  The reference reads the same dict.  The program's
loaders (``build_gmm``, ``build_extractor``) take host arrays and derive
their packed and bf16 matrices themselves, so these pass through the
host once at set-up.
"""

import math

import torch

from benchmark.models import draw


def make_weights(cfg: dict, seed: int, device) -> dict:
    c, d = cfg["ubm_components"], 3 * cfg["frontend"]["num_ceps"]
    iv, r, spk = cfg["ivector_dim"], cfg["plda_dim"], cfg["enrolled_speakers"]
    n = draw.Normal()
    a = n.add((c, d, d), 0.1)
    means = n.add((c, d), 1.0)
    m = n.add((c, d, iv), 0.05)
    b = n.add((c, d, d), 0.1)
    emb_mean = n.add((iv,), 0.1)
    transform_mat = n.add((r, iv + 1), 0.05)
    plda_mean = n.add((r,), 0.1)
    plda_q = n.add((r, r), 1.0)
    plda_psi = n.add((r,), 1.0)
    enroll = n.add((spk, r), 1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n.fill(gen, device)
    eye = torch.eye(d, device=device)
    a, b, means = a(), b(), means()
    invcov = torch.bmm(a, a.transpose(1, 2)) + eye
    mic = torch.bmm(invcov, means[..., None])[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(
        torch.linalg.cholesky(invcov.double()), dim1=1, dim2=2)).sum(-1)
    gconsts = (math.log(1.0 / c) + 0.5 * logdet
               - 0.5 * (d * math.log(2 * math.pi)
                        + (means.double() * mic.double()).sum(-1)))
    return {"gconsts": gconsts.float(),
            "weights": torch.full((c,), 1.0 / c, device=device),
            "mic": mic, "invcov": invcov, "M": m(),
            "sigma_inv": torch.bmm(b, b.transpose(1, 2)) + eye,
            "offset": float(cfg["prior_offset"]),
            "emb_mean": emb_mean(), "transform_mat": transform_mat(),
            "plda_mean": plda_mean(),
            "plda_transform": torch.linalg.qr(plda_q())[0].contiguous(),
            "plda_psi": plda_psi().abs() + 0.5, "enroll": enroll()}


def build_program(w: dict, cfg: dict, program: dict, device):
    """The port's IvPlda on these weights, with the mix's path."""
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.gmm import build_gmm
    from speakerguard_tpu_torch.models.iv_plda import IvPlda, IvPldaParams
    from speakerguard_tpu_torch.models.ivector import build_extractor
    from speakerguard_tpu_torch.models.plda import PLDAParams

    def host(t):
        return t.cpu().numpy()

    params = IvPldaParams(
        fgmm=build_gmm(host(w["gconsts"]), host(w["weights"]),
                       host(w["mic"]), host(w["invcov"]), device=device),
        extractor=build_extractor(host(w["M"]), host(w["sigma_inv"]),
                                  w["offset"], device=device),
        plda=PLDAParams(w["plda_mean"], w["plda_transform"], w["plda_psi"]),
        emb_mean=w["emb_mean"], transform_mat=w["transform_mat"])
    model = IvPlda(params, fast=FastPath(**program["fast_path"]),
                   loglike_kernel=program.get("loglike_kernel", False))
    model.set_enrollment([str(i) for i in range(w["enroll"].shape[0])],
                         w["enroll"])
    return model
