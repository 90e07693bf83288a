"""Driver of the attack-campaign cells: whole attack calls back to back on
fresh seeded batches, as a researcher's ``attack_main`` campaign runs them.

One run:

1. set-up: the weights from the seed on the device, the program's model
   and attack built on them (``ScoreTap`` keeps the final evaluation's
   scores, which decide success, for the judge), and ``warmup_calls``
   whole calls on batches that the window never sees (every shape of the
   window, every kernel built and loaded);
2. ``--trace 0``: the window, calls until ``--seconds`` have passed, each
   on batch i of the seed; ``attack_utts_per_s`` is the utterances of all
   calls over the wall time from the first call's start to the last one's
   end, which ends in a synchronise (the success list each call returns
   is read on the host).  ``--trace 1``: ``trace_calls`` calls under the
   profiler instead, for the per-layer readers;
3. the peak device memory is read, the program freed, and the plain
   reference judges every call's output (``judge.py``).  The peak is the
   program's own: the largest of set-up's and of each call's, less the
   outputs of earlier calls that the harness keeps for the judge.

The mix's file (``traffic/<name>.json``) gives the batch, the wave length
and amplitude, the attack and its settings, the program's path, the
reference's block of rows, the calls to warm, trace and sample, and the
limits of the judged numbers.  The front end's dither is the benchmark's:
the program draws it through the attack's ``dither_fn``, so that the
reference can draw the same.
"""

import gc
import time

import torch

from benchmark import harness, judge, trace as tracing


# The attack that ``reference/pgd.py`` and ``judge.py`` model: untargeted
# CSI PGD on the cross-entropy, one dither a step, no restart.  A mix that
# asks for anything else would be judged against another attack.
JUDGED_ATTACK = {"name": "PGD", "task": "CSI", "targeted": False,
                 "loss": "Entropy", "eot": 1, "restarts": 0}


def check_attack(attack: dict):
    off = {k: attack.get(k, False) for k, v in JUDGED_ATTACK.items()
           if attack.get(k, False) != v}
    if off:
        raise ValueError(f"attack settings {off}: this driver and its "
                         f"judge run {JUDGED_ATTACK} only")


class Campaign:
    """The inputs of one run: batch ``i`` and its dither draws are
    functions of (seed, i) alone."""

    def __init__(self, seed: int, cfg: dict, traffic: dict, device):
        self.seed = seed
        self.cfg = cfg
        self.batch = traffic["batch"]
        self.samples = traffic["samples"]
        self.amplitude = traffic["amplitude"]
        self.speakers = cfg["enrolled_speakers"]
        self.device = device
        self.gen = torch.Generator(device=device)
        self.call = 0            # the call whose dither the hook draws

    def inputs(self, i: int):
        """(waves (B, L) uniform in +-amplitude, labels (B,))."""
        self.gen.manual_seed(harness.derive_seed(self.seed, "batch", i))
        x = torch.rand((self.batch, self.samples), generator=self.gen,
                       device=self.device)
        x = (2.0 * x - 1.0) * self.amplitude
        y = torch.randint(0, self.speakers, (self.batch,), generator=self.gen,
                          device=self.device)
        return x, y

    def dither(self, i: int, it: int, shape, restart=0, repeat=0):
        self.gen.manual_seed(harness.derive_seed(self.seed, "dither", i,
                                                 restart, it, repeat))
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def dither_fn(self, restart, it, repeat, shape):
        """The attack's ``dither_fn`` hook for the current call."""
        return self.dither(self.call, it, shape, restart, repeat)

    def dither_shape(self):
        return judge.dither_shape(self.cfg, self.batch, self.samples)


class ScoreTap:
    """Stands in for the model's ``score`` and keeps the scores of its
    last exact evaluation (no fast path): the final evaluation, whose
    scores decide each call's success.  Nothing else changes."""

    def __init__(self, model):
        self.score = model.score
        self.last = None
        model.score = self

    def __call__(self, x, *args, fast=False, **kwargs):
        scores = self.score(x, *args, fast=fast, **kwargs)
        if not fast:
            self.last = scores
        return scores


class ProgramAttack:
    """The port's attack on the port's model, as the mix states it."""

    def __init__(self, model, traffic: dict, campaign: Campaign):
        from speakerguard_tpu_torch.attacks.gradient import PGD
        a = traffic["attack"]
        self.tap = ScoreTap(model)
        self.pgd = PGD(model, task=a["task"], epsilon=a["epsilon"],
                       step_size=a["step_size"], max_iter=a["max_iter"],
                       num_random_init=a["restarts"], loss=a["loss"],
                       EOT_size=a["eot"], dither_fn=campaign.dither_fn)

    def attack(self, x, y):
        """-> (adversarial waves, success list, final scores)."""
        adv, success = self.pgd.attack(x, y)
        return adv, success, self.tap.last


class ReferenceAttack:
    """The plain reference's PGD in the program's place (the control)."""

    def __init__(self, ref, traffic: dict, campaign: Campaign):
        self.ref = ref
        self.traffic = traffic
        self.atk = traffic["attack"]
        self.campaign = campaign

    def attack(self, x, y):
        c, a = self.campaign, self.atk
        adv, scores, success = judge.pgd.attack(
            self.ref.scores, x, y, a["epsilon"], a["step_size"],
            a["max_iter"], lambda k: c.dither(c.call, k, c.dither_shape()),
            judge.path_scores(self.ref, x, self.traffic))
        return adv, success.tolist(), scores


def run_calls(atk, campaign: Campaign, first: int, seconds=None,
              calls=None):
    """Calls from batch ``first`` on, until ``calls`` are done or
    ``seconds`` have passed -> (outputs, wall seconds, the largest device
    memory that a call held besides the earlier calls' outputs)."""
    outputs = []
    dev = campaign.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kept = peak = 0
    sync()
    t0 = time.perf_counter()
    i = first
    while True:
        x, y = campaign.inputs(i)
        campaign.call = i
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        adv, success, scores = atk.attack(x, y)
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated(dev) - kept)
            kept += (adv.untyped_storage().nbytes()
                     + scores.untyped_storage().nbytes())
        outputs.append((i, adv, success, scores))
        i += 1
        if calls is not None:
            if i - first >= calls:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    sync()
    return outputs, time.perf_counter() - t0, peak


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device, mode: str = "program", calls=None) -> dict:
    """One run of an attack-campaign cell -> the result's fields.
    ``mode``: "program", or "control" (the reference at TF32 in the
    program's place).  ``calls``: a fixed count of window calls in place
    of ``seconds`` (the control's and the tests' runs)."""
    cfg, traffic = cell.config, cell.traffic
    check_attack(traffic["attack"])
    models = harness.part("models", cfg["model"])
    refs = harness.part("reference", cfg["model"])
    wseed = harness.derive_seed(seed, "weights")
    campaign = Campaign(seed, cfg, traffic, device)
    if mode == "control":
        atk = ReferenceAttack(refs.Reference(
            models.make_weights(cfg, wseed, device), cfg, device,
            precision="tf32"), traffic, campaign)
    else:
        atk = ProgramAttack(models.build_program(
            models.make_weights(cfg, wseed, device), cfg, traffic["program"],
            device), traffic, campaign)
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # warm-up batches are numbered below 0: the window never sees them
    _, _, warm_peak = run_calls(atk, campaign, -traffic["warmup_calls"],
                                calls=traffic["warmup_calls"])
    traces = []
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if trace:
        with tracing.stretch(traces):
            outputs, wall, peak = run_calls(atk, campaign, 0,
                                            calls=traffic["trace_calls"])
    else:
        outputs, wall, peak = run_calls(atk, campaign, 0, seconds=seconds,
                                        calls=calls)
    peak = max(setup_peak, warm_peak, peak)
    del atk
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    # the reference's weights are drawn again from the seed: nothing the
    # program did to its own tensors can reach the judge
    ref = refs.Reference(models.make_weights(cfg, wseed, device), cfg,
                         device)
    checks, wrong = judge.judge_attack(ref, campaign, outputs, traffic, seed)
    attempted = len(outputs) * traffic["batch"]
    result = {"checks": checks, "attempted": attempted, "failed": wrong,
              "memory_peak_bytes": peak, "window_s": wall,
              "judge_s": time.perf_counter() - t_judge,
              "values": {"setup_s": setup_s,
                         "attack_utts_per_s": attempted / wall}}
    if trace:
        result["trace"] = traces[0]
        result["context"] = {"cell": cell, "calls": len(outputs),
                             "wall_s": wall}
    return result
