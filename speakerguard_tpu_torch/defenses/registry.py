"""Defense name -> function resolution and CLI-style param parsing.

Port of speakerguard_tpu/defenses/registry.py (reference
defense/defense.py): the same registry of input transformations in four
groups, the same (defense, defense_param, defense_flag, defense_order)
parsing, and the same canonical defense-name string used in artifact paths.
"""

import functools

from speakerguard_tpu_torch.defenses import feature_level as FL
from speakerguard_tpu_torch.defenses import frequency_domain as FD
from speakerguard_tpu_torch.defenses import speech_compression as SC
from speakerguard_tpu_torch.defenses import time_domain as TD

CODECS = ["OPUS", "SPEEX", "AMR", "AAC_V", "AAC_C", "MP3_V", "MP3_C",
          "MULAW", "ADPCM"]

INPUT_TRANSFORMATIONS = [
    "QT", "BDR", "AT", "AS", "MS",                            # time domain
    "DS", "LPF", "BPF",                                       # freq domain
    *CODECS,                                                  # codecs
    "FEATURE_COMPRESSION", "FeCo",                            # feature level
]

ROBUST_TRAINING = ["AdvT"]  # adversarial training

_DEFENSES = {name: getattr(src, name) for src, names in (
    (TD, ("QT", "BDR", "AT", "AS", "MS")), (FD, ("DS", "LPF", "BPF")),
    (SC, CODECS), (FL, ("FEATURE_COMPRESSION", "FeCo"))) for name in names}


def lambda_defense(defense: str, defense_param):
    """Returns f(x, draw=None) (reference defense/defense.py:53-85)."""
    if defense is None:
        return lambda x, draw=None: x
    if defense not in _DEFENSES:
        raise NotImplementedError(f"Unsupported defense {defense}")
    f = _DEFENSES[defense]

    if defense in ("FeCo", "FEATURE_COMPRESSION"):
        cl_m, cl_r, other = (defense_param[0], float(defense_param[1]),
                             defense_param[2])
        return functools.partial(f, method=cl_m, param=cl_r,
                                 other_param=other)
    if defense_param is None:
        return f
    if defense == "BPF":
        param = (float(defense_param[0]), float(defense_param[1]))
    elif defense in ("DS", "AT", "LPF"):
        param = float(defense_param[0])
    else:
        param = int(defense_param[0])
    return functools.partial(f, param=param)


def parser_defense(defense, defense_param, defense_flag, defense_order):
    """defense: list[str]; defense_param: list[str|None] (space-separated
    values); defense_flag: list[int]; defense_order: 'sequential'|'average'.

    Returns ([(flag, fn)], canonical_name) with the reference's
    name-mangling (defense/defense.py:20-50): ``name&param@flag`` joined by
    ``+`` (sequential) or ``$`` (average), spaces in a param as ``#``, no
    param as ``DEFAULT``, and every ``.`` as ``_``."""
    if defense is None:
        return None, None
    if defense_param is None:
        defense_param = [None] * len(defense)
    if not len(defense) == len(defense_param) == len(defense_flag):
        raise ValueError("defense, defense_param and defense_flag differ "
                         "in length")
    sep = "+" if defense_order == "sequential" else "$"
    my_defense, name = [], ""
    for x, y, z in zip(defense, defense_param, defense_flag):
        f = lambda_defense(x, y.split(" ") if y is not None else None)
        my_defense.append([z, f])
        tag = y.replace(" ", "#") if y is not None else "DEFAULT"
        name += f"{x}&{tag}@{z}{sep}"
    return my_defense, name[:-1].replace(".", "_")
