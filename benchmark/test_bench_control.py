"""The control on the card: the plain reference computed at TF32, the step
below the float32 the configurations state, put in the program's place at
a cell's own size, must come out not correct.  Run on the card:

    python -m pytest benchmark/test_bench_control.py -m cuda
"""

import pytest

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["xv_pgd10_b512"])
def test_control_is_not_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import control
    cell = harness.load_cell(workload)
    (rec,) = control.readings(cell, [2**31 + 5], ["control"],
                              cell.traffic["control_calls"],
                              torch.device("cuda", 0))
    assert not rec["correct"], rec["checks"]
