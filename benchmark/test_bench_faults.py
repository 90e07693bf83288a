"""A run's ``correct`` on the CPU at small widths: true for the program as
the cells run it, false with each fault the cells can have planted in the
timed path underneath (``faults.py``).  The look for a card is skipped:
the driver runs on the CPU tensors' plain versions."""

import time

import pytest

from benchmark import faults, harness
from conftest import small_cell

CELLS = {"xv": ("xv_plda", "pgd10_b512"), "iv": ("iv_plda", "pgd10_b256"),
         "iv_gmmk": ("iv_plda", "pgd10_b256_gmmk")}


def _run(cell, cpu, mode="program"):
    out = harness.part("drivers", "attack_campaign").run(
        cell, 2**31 + 77, None, False, time.perf_counter(), cpu, mode=mode,
        calls=2)
    return all(c["value"] <= c["limit"] for c in out["checks"].values()), out


def _cell(name):
    cell = small_cell(*CELLS[name])
    # the CPU has no bf16 GEMM; the fast path still runs its own code
    cell.traffic["program"]["fast_path"]["enabled"] = True
    return cell


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name, cpu):
    ok, out = _run(_cell(name), cpu)
    assert ok, out["checks"]
    assert out["attempted"] == 8 and out["failed"] == 0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", sorted(CELLS))
def test_fault_is_caught(name, fault, cpu):
    with faults.planted(fault):
        ok, out = _run(_cell(name), cpu)
    assert not ok, out["checks"]


@pytest.mark.parametrize("key,value", [
    ("name", "FGSM"), ("task", "SV"), ("targeted", True), ("loss", "Margin"),
    ("eot", 2), ("restarts", 1)])
def test_unjudged_attack_is_refused(key, value, cpu):
    """A mix whose attack the reference and the judge do not model fails
    before anything runs, rather than being judged against another one."""
    cell = _cell("xv")
    cell.traffic["attack"][key] = value
    with pytest.raises(ValueError, match="judge"):
        _run(cell, cpu)
