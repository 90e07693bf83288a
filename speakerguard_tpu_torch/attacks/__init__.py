from speakerguard_tpu_torch.attacks.gradient import FGSM, PGD, CWinf  # noqa: F401
