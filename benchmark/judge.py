"""Whether an attack campaign's outputs are right, judged by the plain
reference once the window has closed.

Four numbers, each with its limit from the mix's file:

eps_violations    samples of the adversarial waves outside the attack's
                  box max(x - eps, -1) .. min(x + eps, 1), or not finite,
                  over every call of the window (exact: limit 0).
score_error       every utterance of ``judge_calls`` calls drawn from the
                  seed (every call when the window has fewer): the
                  largest gap between
                  the scores of the program's final evaluation (the exact
                  float32 pass that decides success) and the reference's
                  float32 scores of the returned wave with the same dither,
                  as a share of the median spread of an utterance's
                  scores.
decision_gap      every utterance of the same calls: the reference's float32
                  scores of the returned wave, with the final evaluation's
                  dither, and the gap by which the success the program
                  claimed lies below what those scores say (for a claimed
                  success, how far the true speaker's score is above the
                  best other; for a claimed failure, how far the best
                  other is above the true speaker's), the widest over all
                  utterances, as a share of the median spread of an
                  utterance's scores.
attack_shortfall  rows drawn from the seed: the reference runs its own
                  float32 PGD from the same input with the same dither;
                  one less the ratio of the cross-entropy gain that the
                  program's waves reach to the gain the reference's reach,
                  both read by the reference at the final dither.
"""

import torch

from benchmark import harness
from benchmark.reference import frontend, pgd


def _margin(scores, y):
    """(true speaker's score) - (best other speaker's score), per row."""
    true = scores.gather(1, y[:, None].long())[:, 0]
    other = scores.scatter(1, y[:, None].long(), float("-inf")).amax(1)
    return true - other


def judge_attack(ref, campaign, outputs, traffic: dict, seed: int) -> tuple:
    """-> (checks {name: {"value", "limit"}}, utterances judged wrong).
    ``outputs``: (call index, adversarial waves, success list, final
    scores) per call."""
    atk = traffic["attack"]
    limits = traffic["limits"]
    block = traffic["reference_block"]
    iters = atk["max_iter"]
    eps = atk["epsilon"]
    violations, gaps, spreads, off_rows, errors = 0, [], [], [], []
    gen = torch.Generator()
    gen.manual_seed(harness.derive_seed(seed, "judge"))
    judged = set(torch.randperm(len(outputs), generator=gen)[
        :traffic["judge_calls"]].tolist())
    for n, (i, adv, success, final_scores) in enumerate(outputs):
        x, y = campaign.inputs(i)
        lower, upper = pgd.bounds(x, eps)
        off = (~torch.isfinite(adv)) | (adv < lower) | (adv > upper)
        violations += int(off.sum())
        off_rows.append(off.any(1))
        if n not in judged:
            continue
        final = campaign.dither(i, iters, campaign.dither_shape())
        claimed = torch.as_tensor(success, device=adv.device)
        call_gaps = []
        with torch.no_grad():
            for s in range(0, adv.shape[0], block):
                sc = ref.scores(adv[s:s + block], final[s:s + block])
                errors.append((final_scores[s:s + block] - sc).abs().amax(1))
                m = _margin(sc, y[s:s + block])
                call_gaps.append(torch.where(claimed[s:s + block], m, -m)
                                 .clamp(min=0.0))
                spreads.append(sc.amax(1) - sc.amin(1))
        gaps.append(torch.cat(call_gaps))
        del final
    scale = float(torch.cat(spreads).median())
    gap = torch.cat(gaps) / scale
    err = torch.cat(errors) / scale
    bad_rows = int((gap > limits["decision_gap"])
                   .logical_or(err > limits["score_error"]).sum()
                   + torch.cat(off_rows).sum())
    checks = {"eps_violations": {"value": violations,
                                 "limit": limits["eps_violations"]},
              "score_error": {"value": float(err.max()),
                              "limit": limits["score_error"]},
              "decision_gap": {"value": float(gap.max()),
                               "limit": limits["decision_gap"]}}
    short = shortfall(ref, campaign, outputs, traffic, seed)
    if short is not None:
        checks["attack_shortfall"] = {"value": short,
                                      "limit": limits["attack_shortfall"]}
    return checks, bad_rows


def shortfall(ref, campaign, outputs, traffic, seed):
    """One less the ratio of the program's cross-entropy gain to the
    reference PGD's, on rows drawn from the seed; None with no rows."""
    atk = traffic["attack"]
    n_calls = min(traffic["shortfall_calls"], len(outputs))
    n_rows = traffic["shortfall_rows"]
    if n_calls == 0 or n_rows == 0:
        return None
    gen = torch.Generator()
    gen.manual_seed(harness.derive_seed(seed, "shortfall"))
    picks = torch.randperm(len(outputs), generator=gen)[:n_calls].tolist()
    shape = campaign.dither_shape()
    gain_prog = gain_ref = 0.0
    for p in sorted(picks):
        i, adv = outputs[p][:2]
        rows = torch.randperm(adv.shape[0], generator=gen)[:n_rows]
        rows = rows.sort().values.to(adv.device)
        x, y = campaign.inputs(i)
        grad_fn = path_scores(ref, x, traffic)
        x, y = x[rows], y[rows]

        def dither(k, i=i, rows=rows):
            return campaign.dither(i, k, shape)[rows]
        ref_adv, _, _ = pgd.attack(ref.scores, x, y, atk["epsilon"],
                                   atk["step_size"], atk["max_iter"], dither,
                                   grad_fn)
        final = dither(atk["max_iter"])
        with torch.no_grad():
            base = pgd.cross_entropy(ref.scores(x, final), y).sum()
            prog = pgd.cross_entropy(ref.scores(adv[rows], final), y).sum()
            mine = pgd.cross_entropy(ref.scores(ref_adv, final), y).sum()
        gain_prog += float(prog - base)
        gain_ref += float(mine - base)
    return 1.0 - gain_prog / gain_ref


def path_scores(ref, x, traffic):
    """The reference's scores along the mix's gradient path for the call
    whose clean waves are ``x``: its frozen context, if the path has one,
    worked out by the reference from ``x``."""
    ctx = ref.path_context(x, traffic["program"]["fast_path"],
                           traffic["reference_block"])
    return lambda wav, dither: ref.scores(wav, dither, ctx)


def dither_shape(cfg: dict, batch: int, samples: int) -> tuple:
    """(B, T, window) of the front end's dither draw."""
    win, _, _, t = frontend.geometry(cfg["frontend"], samples)
    return (batch, t, win)
