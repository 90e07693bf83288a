"""Faults planted in the program's timed path, for the checks that
``correct`` catches them (``control.py`` on the card at a cell's size,
``test_bench_faults.py`` on the CPU at a small one).  Each is a context
manager that patches the port's attack loop and restores it on exit.

unchanged   every PGD step returns its state unchanged (the gradient is
            zero, so sign() moves nothing)
half        half of the batch left out: the second half's rows get no
            gradient
answer      one answer altered where it is produced: the first success
            flag of every call is flipped
"""

import contextlib

FAULTS = ("unchanged", "half", "answer")


@contextlib.contextmanager
def planted(name: str):
    from speakerguard_tpu_torch.attacks import gradient
    if name not in FAULTS:
        raise ValueError(f"fault {name!r} not in {FAULTS}")
    if name == "answer":
        orig = gradient.PGD.compare

        def compare(self, y, y_pred, targeted):
            out = orig(self, y, y_pred, targeted)
            return [not out[0]] + out[1:]
        gradient.PGD.compare = compare
        try:
            yield
        finally:
            gradient.PGD.compare = orig
        return
    orig_eot = gradient.eot

    def eot(score_fn, loss_fn, threshold, eot_size=1):
        run = orig_eot(score_fn, loss_fn, threshold, eot_size)

        def faulty(x, y, rng):
            scores, loss, grad, dec = run(x, y, rng)
            if name == "unchanged":
                grad = grad * 0.0
            else:
                grad = grad.clone()
                grad[grad.shape[0] // 2:] = 0.0
            return scores, loss, grad, dec
        return faulty
    gradient.eot = eot
    try:
        yield
    finally:
        gradient.eot = orig_eot
