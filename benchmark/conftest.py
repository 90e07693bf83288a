"""The benchmark's own tests (``python -m pytest benchmark``): the repo
root on the path, and small cells that run on the CPU."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


def small_config(name: str) -> dict:
    """A configuration at widths a CPU test runs in seconds: the same
    front end and layer kinds, fewer channels and components."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    if name == "xv_plda":
        cfg["tdnn"] = [[k, d, 32 if c != 1500 else 64]
                       for k, d, c in cfg["tdnn"]]
        cfg.update(embedding_dim=32, lda_dim=16, num_classes=8)
    else:
        cfg.update(ubm_components=16, ivector_dim=32, plda_dim=16)
    return cfg


def small_cell(config: str, traffic: str, **over):
    """A cell of ``config`` at small widths under the mix ``traffic`` with
    4 waves of 8,000 samples a call."""
    from benchmark import harness
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    mix.update(batch=4, samples=8000, warmup_calls=1, trace_calls=1,
               reference_block=2, shortfall_calls=2, shortfall_rows=4,
               judge_calls=2)
    mix.update(over)
    return harness.Cell(name=f"small_{config}_{traffic}",
                        config=small_config(config),
                        traffic=copy.deepcopy(mix))


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
