"""Task-aware attack losses (port of speakerguard_tpu/attacks/losses.py).

Re-design of reference attack/utils.py:7-116 (SEC4SR_CrossEntropy /
SEC4SR_MarginLoss / resolve_loss): every branch of the task / targeted /
imposter matrix is a mask lane, so the loss is one expression per batch and
never reads labels back to the host.

Conventions preserved exactly:
  * label -1 = imposter / reject
  * SV labels in {0, -1}; CSI/OSI labels in {-1, 0..S-1}
  * clip_max clamps the loss at 0 from below (used by CW2)
  * grad_sign: Entropy: +1 untargeted / -1 targeted; Margin: always -1
"""

import functools

import torch
import torch.nn.functional as F

BIG = 1.0e4


def cross_entropy_loss(scores: torch.Tensor,
                       label: torch.Tensor) -> torch.Tensor:
    """CSI-only cross entropy; imposter (-1) rows contribute 0
    (reference attack/utils.py:7-29).  Returns per-sample loss (B,)."""
    consider = label != -1
    safe_label = torch.where(consider, label, torch.zeros_like(label))
    logp = torch.log_softmax(scores, dim=-1)
    ce = -torch.gather(logp, -1, safe_label[:, None].long())[:, 0]
    return torch.where(consider, ce, torch.zeros_like(ce))


def margin_loss(scores: torch.Tensor, label: torch.Tensor, *,
                task: str = "CSI", targeted: bool = False,
                confidence: float = 0.0, threshold=None,
                clip_max: bool = True) -> torch.Tensor:
    """SEC4SR margin loss, all task branches (reference attack/utils.py:
    31-102).  threshold may be a python float or a scalar tensor."""
    num_class = scores.shape[1]
    conf = confidence
    thr = threshold if threshold is not None else 0.0
    if not isinstance(thr, torch.Tensor):
        # a device-side fill: no host-to-device copy per call
        thr = torch.full((), thr, dtype=scores.dtype, device=scores.device)

    if task == "SV":
        s = scores[:, 0]
        # (label==0) == targeted  ->  thr + conf - s   else  s + conf - thr
        flip = (label == 0) == targeted
        loss = torch.where(flip, thr + conf - s, s + conf - thr)
    elif task in ("CSI", "OSI"):
        consider = label != -1
        safe_label = torch.where(consider, label, torch.zeros_like(label))
        one_hot = F.one_hot(safe_label.long(), num_class).to(scores.dtype)
        score_real = torch.sum(one_hot * scores, dim=1)
        score_other = torch.max((1.0 - one_hot) * scores - one_hot * BIG,
                                dim=1).values
        score_max = torch.max(scores, dim=1).values
        if targeted:
            if task == "CSI":
                enrolled = score_other + conf - score_real
            else:
                enrolled = torch.maximum(score_other, thr) + conf - score_real
        else:
            if task == "CSI":
                enrolled = score_real + conf - score_other
            else:
                f_reject = score_max + conf - thr
                f_mis = torch.maximum(score_real, thr) + conf - score_other
                enrolled = torch.minimum(f_reject, f_mis)
        if task == "OSI":
            imposter = (score_max + conf - thr if targeted
                        else thr + conf - score_max)
        else:
            imposter = torch.zeros_like(score_max)
        loss = torch.where(consider, enrolled, imposter)
    else:
        raise ValueError(task)

    if clip_max:
        loss = torch.clamp(loss, min=0.0)
    return loss


def resolve_loss(loss_name: str = "Entropy", targeted: bool = False,
                 confidence: float = 0.0, task: str = "CSI", threshold=None,
                 clip_max: bool = True):
    """Returns (loss_fn(scores, label) -> (B,), grad_sign)
    (reference attack/utils.py:104-116: SV/OSI force Margin)."""
    if loss_name not in ("Entropy", "Margin"):
        raise ValueError(f"unknown loss {loss_name!r}")
    if task not in ("CSI", "SV", "OSI"):
        raise ValueError(f"unknown task {task!r}")
    if task in ("SV", "OSI") or loss_name == "Margin":
        loss_fn = functools.partial(
            margin_loss, task=task, targeted=targeted, confidence=confidence,
            threshold=threshold, clip_max=clip_max)
        grad_sign = -1 if loss_name == "Margin" else (1 - 2 * int(targeted))
        if task in ("SV", "OSI"):
            grad_sign = -1
    else:
        loss_fn = cross_entropy_loss
        grad_sign = 1 - 2 * int(targeted)
    return loss_fn, grad_sign


def majority_vote(decisions: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Majority vote over EOT-repeat decisions (reference attack/utils.py:
    118-125).  decisions: (E, B) in {-1..num_classes-1} -> (B,).  Ties
    resolve to the smallest label."""
    counts = torch.sum(F.one_hot(decisions.long() + 1, num_classes + 1),
                       dim=0)
    return (torch.argmax(counts, dim=-1) - 1).to(torch.int32)


def compare(y: torch.Tensor, y_pred: torch.Tensor,
            targeted: bool) -> torch.Tensor:
    """Success test (reference attack/Attack.py:11-15)."""
    return (y_pred == y) if targeted else (y_pred != y)
