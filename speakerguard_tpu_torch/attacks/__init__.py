from speakerguard_tpu_torch.attacks.gradient import FGSM, PGD, CWinf  # noqa: F401
from speakerguard_tpu_torch.attacks.cw2 import CW2  # noqa: F401
from speakerguard_tpu_torch.attacks.fakebob import FAKEBOB  # noqa: F401
from speakerguard_tpu_torch.attacks.kenan import Kenan  # noqa: F401
from speakerguard_tpu_torch.attacks.siren import SirenAttack  # noqa: F401
