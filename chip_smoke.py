#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (speakerguard_tpu_torch) on one card.

    python3 chip_smoke.py                 # what the checks need
    python3 chip_smoke.py --profile DIR   # also a torch.profiler table of
                                          # one PGD iteration of each slice
                                          # (one CW2 inner step of the CW2
                                          # slices, one NES iteration of the
                                          # FAKEBOB slices), written to
                                          # DIR/profile_<slice>.txt
    python3 chip_smoke.py --rounds N      # also N rounds of PGD-10 on the
                                          # three FastPath() slices in turn

Phases, one JSON line each:
  1. device   the card's name and power limit (nvidia-smi); exits non-zero
              when torch sees no CUDA card.
  2. build    nvcc builds the port's kernel sources, csrc/chol.cu,
              csrc/gmm.cu, csrc/gmm_stats_fwd.cu, csrc/gmm_stats_bwd.cu and
              csrc/adpcm.cu, one process each, side by side, into
              csrc/_build/.
  3. launch   each of fused_loglike's two launches (the three-piece bf16
              split of aug(x), the six-product split GEMM; the projection's
              split between them is plain torch), of stats_fwd's three
              (aug16, the loglike GEMM with its softmax partials,
              normalise-and-stats) and of stats_bwd's three (dl and the
              direct term, the daug GEMM, the chain rule and sum) against
              its plain version at the main and ragged shapes and at
              slice_defended_iv's 64 x 150 frames, with its CUDA-event time
              at the main shape; fused_loglike's also at slice_siren_iv's
              guard shape (16 x 300 frames), stats_fwd's also at its
              particle shape (400 x 300 frames), timed there too.
  4. kernel   each kernel against its plain PyTorch version on the card at
              the main path's shapes and at ragged ones (the GMM kernels
              also at slice_defended_iv's 64 x 150 frames, timed and
              bounded there too): error, CUDA-event
              times of the kernel, the plain version and one PyTorch library
              call, and the roofline bound.  cholesky_rt on a diagonally
              dominant and an i-vector-shaped input (also the blocked
              residual and strictly-lower zeros); cholesky_rt_dinv (R equal
              to cholesky_rt's, dinv_t inverting R's blocks, pad blocks
              identity); chol_solve (against plain and float64).  At the
              main shape each Cholesky call's device kernels are counted
              with torch.profiler (1 for cholesky_rt, 2 for
              cholesky_rt_dinv and chol_solve: the sweep and its tail), and
              the latter two also time the sweep alone (sweep_ms);
              fused_loglike (against plain, and against a float64 product
              beside the plain f32 one), stats_fwd and stats_bwd (the
              latter on the posts16 stats_fwd produced); stats_fwd also
              beside the same bf16 addmm on the 64-column-padded operands
              its GEMM takes, stats_bwd also beside its own product
              bf16(dl) . proj16^T as one torch.mm with an f32 output.
  5. xv_blocks  each TDNN fast block (_BlockFast, _BlockFastBf16 for each
              of the five layers; the two stats pools) forward and backward
              at the xv headline shape (batch 512, T=300 frames) against its
              plain version, with CUDA-event ms; then xv_small_reference:
              the card's xv-PLDA scores against the CPU plain path on a
              model from the same numpy seed.
  6. slice    the main path at full width: iv-PLDA (C=2048, D=72, IV=600,
              R=200, weights from a numpy seed), 10 enrolled speakers, task
              CSI-E, 64 utterances of 3 s; make_decision, then PGD (10
              iterations, eps 0.002, step 0.0004, Entropy) on the exact
              gradient path (FastPath(enabled=False)).  The launch counts
              are set to 0 just before and read just after: cholesky_rt
              once per PGD iteration plus once per exact evaluation (12).
              The card's scores are checked against the CPU plain path on a
              small model.
  7. slice_fast_kernels  the same run with FastPath(gmm_topk=0,
              stats_kernel=True) and loglike_kernel=True: stats_fwd and
              stats_bwd once per iteration (10 each), fused_loglike once per
              exact evaluation (2), cholesky_rt 12; no plain call anywhere.
  8. slice_fast_default  the same run with FastPath() (top-K 256, the
              unfused bf16 stats): cholesky_rt 12.
  9. slice_chol_dinv  FastPath() with spd_solver="cholesky_rt_dinv":
              cholesky_rt_dinv 12 (the backward reuses factor and dinv_t),
              cholesky_rt 0.
 10. slice_chol_solve  FastPath() with spd_solver="chol_solve": chol_solve
              22 (forward and backward of each iteration, and the two exact
              evaluations), cholesky_rt 0.
 11. rounds   (--rounds N) ms per PGD iteration of slice_fast_default,
              slice_chol_dinv and slice_chol_solve, N rounds, the order
              rotated each round: the three differ only in the SPD solver.
 12. slice_xv  xv-PLDA, the JAX package's headline path, at full width
              (TDNN_SPEC widths, 30 ceps, LDA to 150, weights from a numpy
              seed), 10 speakers enrolled from waves, task CSI-E, 512
              utterances of 3 s: make_decision, then PGD-100 (eps 0.002,
              step 0.0004, Entropy) with FastPath() (bf16 TDNN activations,
              bf16 DFT).  No hand kernel lies on this path: every launch
              count is 0.
 13. slice_xv_fast_f32  the same with FastPath(tdnn_bf16_act=False),
              PGD-10.
 14. slice_xv_exact  the same with FastPath(enabled=False), PGD-10.
 15. audionet_small_reference  the card's AudioNet scores and embeddings
              (exact path) against the CPU's on weights from one numpy
              seed.
 16. slice_audionet  AudioNet CSI-NE (the log-mel frontend and the CNN of
              CONV_SPEC, 10 classes, weights from numpy seed 0), 512
              utterances of 3 s: make_decision, then PGD-100 with
              FastPath() (bf16 DFT, bf16 CNN), then FGSM (eps 0.002) on the
              same batch, whose success must equal an exact re-decision of
              its adversarial waves.  No hand kernel lies on this path:
              every launch count is 0.
 17. slice_audionet_exact  the same with FastPath(enabled=False), PGD-10.
 18. slice_cw2_sv  CW2 on iv-PLDA SV (BASELINE.json config 3): the weights of
              slice, dither 0, one speaker enrolled from a wave, the
              threshold the median of the 64 clean scores, the clean
              decisions as labels (0 accept, -1 reject), so one untargeted
              run is both denial of service and bypass.  make_decision,
              then CW2 (3 binary-search steps of 50 Adam steps, early stop
              off, initial const 10: 3 x 51 inner evaluations) on the exact
              path: cholesky_rt 1 + 153.  Its success must equal an exact
              re-decision of its audio and a failed wave must come back
              unchanged.  Then CWinf (eps 0.002, 10 iterations) on the same
              batch, counted apart: cholesky_rt 11.
 19. slice_cw2_sv_fast  the same batch, threshold and labels with the
              default dither, FastPath(gmm_topk=0, stats_kernel=True),
              loglike_kernel=True and CW2(fast=True): stats_fwd and
              stats_bwd 153, cholesky_rt 155 and fused_loglike 2 (the exact
              make_decision and the re-verification of the returned audio).
 20. kernel (case nes)  stats_fwd at 816 x 300 rows and cholesky_rt at
              B = 816 (f32 and bf16_updates), the shapes of one NES
              iteration of slice_fakebob_osi_fast, against their plain
              versions at the main-shape bars, with CUDA-event ms.
 21. slice_fakebob_osi  FAKEBOB on iv-PLDA OSI (BASELINE.json config 4):
              the weights of slice, 10 speakers enrolled from waves, 16
              utterances of 3 s, the model threshold the median of their
              clean max scores (exact, dither 0), the clean decisions as
              labels (speakers and rejects).  estimate_threshold on the two
              rejected waves nearest below the threshold (step 0.1, eps
              0.002, counted apart: cholesky_rt 2 + its NES bodies), then
              make_decision and FAKEBOB-30 (eps 0.002, 50 samples, max lr
              0.001, early stop off) at that estimate on the exact path:
              cholesky_rt 1 + NES bodies.
 22. slice_fakebob_osi_fast  the same batch, model threshold, labels and
              attack threshold with the default dither, FastPath(gmm_topk=0,
              stats_kernel=True), loglike_kernel=True and FAKEBOB(fast=True):
              stats_fwd = NES bodies, fused_loglike = 1 + guard evaluations
              + 1, cholesky_rt = their sum; then the estimation again on
              this model (stats_fwd 0, fused_loglike = cholesky_rt).
 23. slice_fakebob_xv  xv-PLDA at full width, FastPath(), 10 speakers, CSI,
              128 utterances of 3 s: FAKEBOB-5 (fast=True) with the 51
              evaluation points in 3 chunks of 17 (2176 waves each); every
              hand-kernel count 0.  Each FAKEBOB slice's success must equal
              an exact re-evaluation of the margin loss of its audio.
 24. defense_small_reference  QT, BDR, MS (equal), AS, DS, LPF and BPF
              (float32 convolutions) on the card against the CPU, each
              timed at 512 x 3 s; FeCo's k-means (L2, cos) on the card
              against the CPU from the same initial frames: the frames
              assigned differently, and the rows that agree held to rtol
              1e-4.
 25. slice_defended_iv  BASELINE.json config 5 on iv-PLDA: the weights
              and waves of slice, QT("512")@0 + FeCo("kmeans 0.5 L2")@1
              sequential (150 frames left) on FastPath(gmm_topk=0,
              stats_kernel=True) with loglike_kernel=True (each GMM
              kernel held to its plain version at 64 x 150 frames in
              phases 3 and 4), the defended clean decisions as
              labels, PGD-10 with EOT 2 (BPDA through QT): stats_fwd and
              stats_bwd 20 (at 64 x 150 rows), fused_loglike 2,
              cholesky_rt 22.  Success must equal an exact re-decision of
              the returned audio with the final evaluation's FeCo draws.
 26. slice_defended_xv  xv-PLDA at batch 512 (the waves of slice_xv),
              QT("512")@0 + FeCo("kmeans 0.2 L2")@1 on FastPath(), PGD-100
              with EOT 2: every hand-kernel count 0.
 27. slice_defended_xv_avg  the same batch, order "average" over
              QT("512"), BPF("50 5000"), DS("0.5") and MS("3") at flag 0,
              PGD-10 with EOT 1: every count 0.
 28. codec_small_reference  MULAW at 512 x 3 s card vs CPU (rtol 1e-6,
              atol 1e-6 x max; a level may flip only at a near tie); the
              ADPCM kernel torch.equal to its plain loop on the card at
              512 x 4,800 samples and on the CPU on 16 x 48,000 (waves 0-7
              and 504-511), for bits 2..16 at 64 x 2,000 and on the edge
              inputs (adpcm_edge_waves); the fused ADPCM defense equal to
              the unfused composition; its ms at 512 x 48,000 and cycles a
              sample beside the plain loop's and its bounds (bytes; the
              serial chain, adpcm_bound_ms); OPUS and SPEEX at 8 x 3 s
              through a stand-in ffmpeg written to a temporary directory
              and put first on PATH for this phase only (output equal to
              its quantisation, BPDA gradient equal to the incoming one),
              and the real codecs where the machine has an ffmpeg.
 29. kernel (case siren)  stats_fwd at 400 x 300 frames, cholesky_rt at
              B = 400 (f32 and bf16_updates), fused_loglike at 16 x 300
              frames: slice_siren_iv's shapes, at the main-shape bars,
              timed and bounded.
 30. slice_defended_adpcm_xv  xv-PLDA, FastPath(), ADPCM 4 @0, PGD-10 with
              EOT 1 at 512 x 3 s: adpcm 12 (once per forward), every other
              count 0; success equal to an exact re-decision.
 31. slice_kenan_ssa_xv  xv-PLDA, Kenan ssa, 15 steps at 4 x 3 s (window
              2400): every count 0; the SVD's ms per wave and driver, the
              full reconstruction within 1e-4 of max |x|, the top 100
              squared singular values within rtol 1e-3 of the float64
              eigenvalues of the Gram matrix; success equal to an exact
              re-decision.
 32. slice_siren_xv  xv-PLDA, FastPath(), SirenAttack(fast=True), batch
              32, 25 particles, 2 epochs x 30 iterations, abort off (800
              waves an evaluation): every count 0.
 33. slice_kenan_fft_iv  iv-PLDA, FastPath(enabled=False),
              loglike_kernel=True, dither 0, Kenan fft 15 steps at batch 64:
              fused_loglike and cholesky_rt 16 (one per decision).
 34. slice_siren_iv  iv-PLDA, FastPath(gmm_topk=0, stats_kernel=True),
              loglike_kernel=True, SirenAttack(fast=True), batch 16, 25
              particles, 2 epochs x 30 iterations, abort off: stats_fwd =
              particle evaluations (120,000 rows each), fused_loglike =
              guard forwards + 2, cholesky_rt their sum, stats_bwd 0.  Each
              Siren slice's success must equal an exact re-evaluation of
              its audio (the final re-scoring's dither replayed).
 35. train_small_reference  one f32 natural AudioNet train step (10
              classes, 4 x 16,000 samples) on the card and the CPU from the
              same weights and augmentation draws: loss, every gradient
              leaf, the new BN state, the parameters; then the checkpoint
              round trip on the card (the resumed step's loss).
 36. slice_train_natural  AudioNet training at the JAX bench's point
              (bench.py:63-132): 251 classes, batch 128 of 80,000 samples,
              Adam 1e-3, aug_eps 0.002 (256 waves a step), f32; two warm-up
              steps (cuDNN's autotuning), 5 timed steps; the loss falls, the parameters, Adam's
              state and the BN state stay float32 and finite; ms per step,
              utterances/s (batch / step time), peak memory, the CUDA-event
              ms of the frontend, the CNN forward, forward and backward and
              Adam, and one profiled step (the device's busy share).  No
              hand kernel lies on the training path: every count 0.
 37. slice_train_natural_bf16  the same with compute_dtype="bf16".
 38. slice_train_adver  the same point with PGD-10 (eps 0.002, step
              0.0004) on half the batch against the live model, aug_eps 0,
              f32: two warm-up and 3 timed steps; the adversarial half
              within eps of the clean waves and in [-1, 1]; acc_adv and
              acc_nor.
 39. slice_train_data  the trainer's input path: a synthetic Spk251_train
              tree (251 speakers x 1 WAV of 6 s) in a temporary directory,
              the label encoder, one epoch of f32 natural steps at batch
              128 through Spk251_train(..., wav_length=80000,
              seed=0).batches(128, shuffle=True): two batches (128, 123),
              both served by the native WAV loader (built with g++ into
              csrc/_build/), a finite loss.
 40. kernel (case cli)  cholesky_rt at cli_iv's shapes: B = 40 (f32, and
              bf16 input with bf16_updates) and B = 1, against its plain
              version at the main-shape bars, timed and bounded.
 41. cli_xv   the evaluation workflow through the port's CLIs
              (speakerguard_tpu_torch/cli/), in process with their default
              -device cuda, on a world written to a temporary directory
              (Spk10_enroll 10 speakers x 2, Spk10_test 10 x 4,
              Spk10_imposter 5 others x 2, 3 s each, numpy seed 0):
              xv-PLDA at full width (random_xv_plda_params(default_rng(0))
              as a reference TDNN state dict through torch.save, PLDA,
              mean and transform in Kaldi text): enroll, set_threshold (its
              dict printed), specify_target_label, attack_main (-batch_size
              40 -wav_length 48000 -task CSI PGD at the CLI's defaults),
              attack_main again (every batch "Exists, Skip"), test_attack on
              the adversarial directory and in imperceptibility mode; the
              seconds of each CLI, ms per PGD iteration, peak memory, the
              metric means; every launch count 0.  Checks: every written
              wave within eps of its source after the int16 write-back (one
              LSB of slack), one WAV per test utterance, attack_main's
              success equal to an exact re-decision of its float audio with
              the final evaluation's dither replayed, test_attack's
              decisions equal to undithered decisions of the read-back
              waves (so the waves where attack_main and test_attack differ
              flip between those two; they are listed).
 42. cli_iv   the same sequence on iv-PLDA at D=72 (24 ceps), IV=600,
              R=200 and C=256 (cut from 2048) from Kaldi text: cholesky_rt
              once a model evaluation (enroll 380, set_threshold 50,
              specify_target_label 40, attack_main 11, test_attack 40 and
              40, the resumed attack_main 0), every other count and every
              plain call 0.
 43. cli_audionet  AudioNet CSI-NE (CONV_SPEC, 10 classes) from a checkpoint
              of the port's save_checkpoint and a label encoder:
              attack_main FGSM, the resumed attack_main, test_attack; every
              count 0.
 44. train_cli_natural  the port's natural_train CLI in process (default
              -device cuda) at the JAX bench's point over slice_train_data's
              251 WAVs (batches of 128 and 123) and a Spk251_test tree of
              the same speakers x 3 s: 2 epochs with validation, a resume
              of 1 epoch from the final pickle (-start_epoch 2), 1 epoch
              with -ckpt_backend dcp and 1 more resumed from its directory;
              each run's seconds from a StageTimer and ms a step (the
              median of every step after the first epoch, whose two
              steps autotune cuDNN for their shapes); the loss falls over the first run,
              the checkpoints' epochs and the resumed logs continue the
              count, the dcp directories exist; every count 0.
 45. train_cli_adver  adver_train, PGD-10 at ratio 0.5, 1 epoch,
              -evaluate_adver; each step's seconds (each its shape's
              first, cuDNN autotuning included); every count 0.
 46. dp_one_card  parallel/ on one card (the collective code path, not
              scaling): two ranks spawned on cuda:0 with gloo run
              parallel/rank_checks.py, the DP natural step at global batch
              128 (64 a rank) in float32 and in float64, and PGD-10 with
              mesh= on iv-PLDA at full width, FastPath(), batch 64 (the
              shared top-K all-reduced, cholesky_rt 11 on each rank); the
              float32 DP step again on one rank under nccl; each held
              against this process's run without a group (the step at the
              CPU tests' bars, every parameter in float64, those after
              the last max-pool in float32, where a near tie in an
              earlier pool window can flip; the success list and the
              top-K selection equal).  --profile DIR: rank 0 traces one
              DP step into DIR/dp_trace (utils/profiling.trace).
 47. kernels  one line listing every ported kernel (fused_loglike,
              stats_fwd and stats_bwd with the time of each of their
              launches; stats_fwd and cholesky_rt with their NES-shape
              case; fused_loglike, stats_fwd and stats_bwd with their
              defended-shape case, 64 x 150 frames; fused_loglike,
              stats_fwd and cholesky_rt with their siren-shape case;
              cholesky_rt with its cli-shape case), with
              its launches on every slice, and the port's own kernel
              adpcm (no Pallas counterpart).
Then the card's name and power limit, and last the line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, warmup, iters):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parse_ms(text):
    """'53.677ms' / '812.5us' / '1.2s' (torch.profiler's units) -> ms."""
    text = text.strip()
    for unit, scale in (("ms", 1.0), ("us", 1e-3), ("s", 1e3)):
        if text.endswith(unit):
            return float(text[:-len(unit)]) * scale
    raise ValueError(f"unknown time unit in {text!r}")


def check_kernels_per_call(torch, rec, fn, expected, margin_s=0.1):
    """Count the device kernels that one call of ``fn`` runs, as
    torch.profiler's CUDA activity records them, into ``rec``, and raise
    unless there are ``expected``.  Copies and fills are device events but
    not kernels.  The call runs ``margin_s`` after the trace starts and
    ends as long before it stops: the trace keeps only device events that
    its host-clock window holds, and a kernel launched at once after the
    start can fall before it."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    count = sum(not n.startswith(("Memcpy", "Memset")) for n in names)
    rec["device_kernels_per_call"] = count
    rec["device_kernels_expected"] = expected
    rec["device_events"] = sorted(set(names))
    if count != expected:
        raise RuntimeError(f"{rec['kernel']}: {count} device kernels in one "
                           f"call, expected {expected}: {names}")


def _bound(byte_ms, op_ms):
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms
                                 else "operations")


def _chol_op_ms(b, n, bf16_updates, nb):
    """The factorization's N^3/3 flops per matrix on this card: the
    trailing-update share at the bf16 rate when its operands are bf16, the
    pivot steps at the f32 rate."""
    total = n ** 3 / 3.0
    panel = 0.0   # flops of the sequential pivot steps inside the panels
    for k0 in range(0, n, nb):
        p = min(nb, n - k0)
        for j in range(p):
            panel += 2.0 * (p - j - 1) * (n - k0 - j - 1) + (n - k0 - j)
    trailing = max(total - panel, 0.0)
    if bf16_updates:
        return b * (panel / F32_FLOPS + trailing / BF16_FLOPS) * 1e3
    return b * total / F32_FLOPS * 1e3


def chol_bound_ms(b, n, in_bytes, bf16_updates, nb):
    """Least time for the factorization on this card: the upper triangle of
    each input read once and the f32 factor written once, against N^3/3
    flops per matrix."""
    byte_ms = (b * (n * (n + 1) / 2 * in_bytes + n * n * 4)
               / HBM_BYTES_PER_S * 1e3)
    return _bound(byte_ms, _chol_op_ms(b, n, bf16_updates, nb))


def chol_dinv_bound_ms(b, n, in_bytes, bf16_updates, nb, m=128):
    """cholesky_rt_dinv: the factorization's bytes plus dinv_t written once
    (K = ceil(N/m) blocks of m x m f32), its flops plus the inversion of
    each diagonal block at the f32 rate, (s^3 - s)/3 + s flops for a block
    of s real rows (the identity on the pad diagonal takes none)."""
    k = -(-n // m)
    byte_ms = (b * (n * (n + 1) / 2 * in_bytes + n * n * 4 + k * m * m * 4)
               / HBM_BYTES_PER_S * 1e3)
    inv = sum((s ** 3 - s) / 3.0 + s
              for s in (min(m, n - i * m) for i in range(k)))
    return _bound(byte_ms, _chol_op_ms(b, n, bf16_updates, nb)
                  + b * inv / F32_FLOPS * 1e3)


def chol_solve_bound_ms(b, n, nb):
    """chol_solve (float32): the upper triangle of A and v read once, x
    written once; the factorization's flops plus N^2 for carrying v
    through the sweep and N^2 for the back-substitution."""
    byte_ms = b * (n * (n + 1) / 2 * 4 + 2 * n * 4) / HBM_BYTES_PER_S * 1e3
    return _bound(byte_ms, _chol_op_ms(b, n, False, nb)
                  + b * 2.0 * n * n / F32_FLOPS * 1e3)


def spd_batch(torch, kind, b, n, seed, dtype):
    """'dominant': 0.01 X X^T + (N/10 + 0.5) I, off-diagonals of R ~ 0.03
    against a diagonal ~ 8.  'occupancy': shaped like the i-vector solve's
    L = I + sum_c N_c M_c^T M_c with few occupied components (2N / 72 of
    them, 72 feature dims each), so R's off-diagonals reach ~1 against a
    diagonal ~ 6 and a wrong trailing update shows at once."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    eye = torch.eye(n, device="cuda")
    if kind == "dominant":
        x = torch.randn((b, n, n), generator=g, device="cuda") * 0.1
        a = x @ x.mT + (n / 10.0 + 0.5) * eye
    else:
        comps = -(-2 * n // 72)
        m = torch.randn((comps * 72, n), generator=g, device="cuda") * 0.05
        occ = torch.rand((b, comps), generator=g, device="cuda") * 30.0
        a = eye + torch.einsum("kn,bk,km->bnm", m,
                               occ.repeat_interleave(72, dim=1), m)
    return a.to(dtype)


def phase_kernels(torch, chol):
    """Kernel vs plain on the card.  Returns the main-shape record.

    Every case holds the kernel's factor to ``chol.blocked_residual`` (A
    rebuilt from R with the sweep's own grouping and rounding) at 1e-5 of
    max |A|, and to the plain version at ``tol_plain`` of max |R|: 1e-5,
    except bf16_updates on the occupancy input at 2e-3.  There an f32
    summation-order difference of one ulp can move one of the 11.5M R
    entries across a bf16 rounding boundary, and the two factors then
    differ by ~2.4e-4; a skipped trailing update errs far above that
    there."""
    tol = 1e-5
    cases = [  # (name, input, B, N, dtype, bf16_updates, tol vs plain)
        ("main_f32", "dominant", 64, 600, torch.float32, False, tol),
        ("bf16_input", "dominant", 64, 600, torch.bfloat16, False, tol),
        ("bf16_updates", "dominant", 64, 600, torch.float32, True, tol),
        ("occupancy_f32", "occupancy", 64, 600, torch.float32, False, tol),
        ("occupancy_bf16_updates", "occupancy", 64, 600, torch.float32,
         True, 2e-3),
        ("odd_129", "dominant", 3, 129, torch.float32, False, tol),
        ("n_1", "dominant", 2, 1, torch.float32, False, tol),
    ]
    main = None
    for name, kind, b, n, dtype, upd, tol_plain in cases:
        a = spd_batch(torch, kind, b, n, seed=n, dtype=dtype)
        got = chol.cholesky_rt(a, bf16_updates=upd)
        torch.cuda.synchronize()
        want = chol.cholesky_rt_plain(a, bf16_updates=upd)
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        lower_zero = bool(torch.all(torch.tril(got, -1) == 0))
        resid = chol.blocked_residual(a, got, upd)
        rec = {"phase": "kernel", "kernel": "cholesky_rt", "case": name,
               "input": kind, "shape": [b, n, n],
               "dtype": str(dtype).split(".")[-1], "bf16_updates": upd,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance_vs_plain": tol_plain, "blocked_residual": resid,
               "plain_blocked_residual": chol.blocked_residual(a, want, upd),
               "tolerance_residual": tol, "strictly_lower_zero": lower_zero}
        if n >= 600 and kind == "dominant":
            a32 = a.float()
            rec["ms"] = cuda_ms(lambda: chol.cholesky_rt(a, upd), 3, 20)
            rec["plain_ms"] = cuda_ms(
                lambda: chol.cholesky_rt_plain(a, upd), 1, 3)
            rec["library_ms"] = cuda_ms(
                lambda: torch.linalg.cholesky(a32, upper=True), 3, 20)
            rec["bound_ms"], rec["bound_by"] = chol_bound_ms(
                b, n, a.element_size(), upd, chol.NB)
        if name == "main_f32":
            check_kernels_per_call(torch, rec,
                                   lambda: chol.cholesky_rt(a, upd), 1)
        emit(rec)
        if not (lower_zero and resid <= tol and rel_err <= tol_plain):
            raise RuntimeError(f"cholesky_rt {name}: rel err {rel_err} "
                               f"(tol {tol_plain}), blocked residual {resid} "
                               f"(tol {tol}), lower zero {lower_zero}")
        if name == "main_f32":
            main = rec
    return main


def _inv_times_d_err(torch, r, dinv_t, m=128):
    """max |dinv_t[:, i]^T D_i - I| over R's diagonal blocks padded with
    identity (the JAX package's check, tests/test_pallas.py:264-272), and
    whether the pad rows and columns of the last block hold exactly the
    identity."""
    b, n = r.shape[0], r.shape[-1]
    k = dinv_t.shape[1]
    eye = torch.eye(m, device=r.device)
    err = 0.0
    for i in range(k):
        s = min(m, n - i * m)
        d = eye.repeat(b, 1, 1)
        d[:, :s, :s] = r[:, i * m:i * m + s, i * m:i * m + s]
        err = max(err, float((dinv_t[:, i].mT @ d - eye).abs().max()))
    s = n - (k - 1) * m
    last = dinv_t[:, k - 1]
    pad_ok = bool(torch.equal(last[:, s:, s:], eye[s:, s:].expand(
        b, m - s, m - s)) and torch.all(last[:, s:, :s] == 0)
        and torch.all(last[:, :s, s:] == 0))
    return err, pad_ok


def phase_chol_dinv(torch, chol):
    """cholesky_rt_dinv against cholesky_rt and its plain version.  Each
    case holds R to the cholesky_rt kernel's R on the same input and flags
    with torch.equal (the same launches compute it); dinv_t to the JAX
    package's bar, max |dinv_t[:, i]^T D_i - I| <= 5e-5; dinv_t to the plain
    inversion of the kernel's own R at 1e-5 of max |dinv_t| (f32 sums of
    up to 128 products in another order); the pad blocks to the identity,
    exactly.  Returns the main-shape record."""
    cases = [  # (name, input, B, N, dtype, bf16_updates)
        ("main_f32", "dominant", 64, 600, torch.float32, False),
        ("bf16_input", "dominant", 64, 600, torch.bfloat16, False),
        ("bf16_updates", "dominant", 64, 600, torch.float32, True),
        ("occupancy_f32", "occupancy", 64, 600, torch.float32, False),
        ("odd_129", "dominant", 3, 129, torch.float32, False),
        ("n_1", "dominant", 2, 1, torch.float32, False),
        ("n_256", "occupancy", 2, 256, torch.float32, False),
    ]
    main = None
    for name, kind, b, n, dtype, upd in cases:
        a = spd_batch(torch, kind, b, n, seed=n, dtype=dtype)
        r, dinv_t = chol.cholesky_rt_dinv(a, bf16_updates=upd)
        r_rt = chol.cholesky_rt(a, bf16_updates=upd)
        torch.cuda.synchronize()
        same_r = bool(torch.equal(r, r_rt))
        inv_err, pad_ok = _inv_times_d_err(torch, r, dinv_t)
        want = chol.diag_block_inverses_t(r)
        abs_err = float((dinv_t - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        rec = {"phase": "kernel", "kernel": "cholesky_rt_dinv", "case": name,
               "input": kind, "shape": [b, n, n],
               "dtype": str(dtype).split(".")[-1], "bf16_updates": upd,
               "r_equal_to_cholesky_rt": same_r,
               "inv_times_d_minus_i": inv_err, "tolerance_inv": 5e-5,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance_vs_plain": 1e-5, "pad_blocks_identity": pad_ok}
        if name == "main_f32":
            main = rec
            # the library's two calls: a factor of A padded to K*128 with
            # identity, then one batched triangular solve of its diagonal
            # blocks against I
            k = dinv_t.shape[1]
            a_pad = torch.eye(k * 128, device="cuda").repeat(b, 1, 1)
            a_pad[:, :n, :n] = a
            eye = torch.eye(128, device="cuda").expand(b, k, 128, 128)

            def library():
                rp = torch.linalg.cholesky(a_pad, upper=True)
                st = rp.stride()   # block i starts 128 i rows and columns in
                blocks = rp.as_strided((b, k, 128, 128),
                                       (st[0], 128 * (st[1] + st[2]), st[1],
                                        st[2]))
                return torch.linalg.solve_triangular(blocks, eye, upper=True)

            rec["ms"] = cuda_ms(lambda: chol.cholesky_rt_dinv(a, upd), 3, 20)
            rec["plain_ms"] = cuda_ms(
                lambda: chol.cholesky_rt_dinv_plain(a, upd), 1, 3)
            rec["library_ms"] = cuda_ms(library, 3, 20)
            rec["library_call"] = (
                "torch.linalg.cholesky(upper=True) of A padded to "
                f"{k * 128} with identity, then one batched "
                "torch.linalg.solve_triangular of its diagonal blocks "
                "against I: two calls (no single call computes the "
                "function)")
            rec["bound_ms"], rec["bound_by"] = chol_dinv_bound_ms(
                b, n, a.element_size(), upd, chol.NB)
            # the sweep alone: cholesky_rt on the same input
            rec["sweep_ms"] = cuda_ms(lambda: chol.cholesky_rt(a, upd), 3,
                                      20)
            check_kernels_per_call(torch, rec,
                                   lambda: chol.cholesky_rt_dinv(a, upd), 2)
        emit(rec)
        if not (same_r and inv_err <= 5e-5 and rel_err <= 1e-5 and pad_ok):
            raise RuntimeError(f"cholesky_rt_dinv {name}: {rec}")
    return main


def phase_chol_solve(torch, chol):
    """chol_solve against its plain version at 1e-5 of max |x| (f32 sums
    in another order in the trailing updates and in the back-substitution's
    matvecs) and against a float64 solve at the JAX package's bar, rtol
    1e-3 and atol 1e-4 (tests/test_pallas.py:214).  Returns the main-shape
    record."""
    main = None
    for name, kind, b, n in [("main_dominant", "dominant", 64, 600),
                             ("occupancy", "occupancy", 64, 600),
                             ("odd_129", "dominant", 3, 129),
                             ("n_1", "dominant", 2, 1)]:
        a = spd_batch(torch, kind, b, n, seed=n + 1, dtype=torch.float32)
        g = torch.Generator(device="cuda").manual_seed(n + 2)
        v = torch.randn((b, n), generator=g, device="cuda")
        x = chol.chol_solve(a, v)
        torch.cuda.synchronize()
        want = chol.chol_solve_plain(a, v)
        abs_err = float((x - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        x64 = torch.linalg.solve(a.double(), v.double()[..., None])[..., 0]
        f64_ok = bool(torch.allclose(x.double(), x64, rtol=1e-3, atol=1e-4))
        rec = {"phase": "kernel", "kernel": "chol_solve", "case": name,
               "input": kind, "shape": [b, n, n], "max_abs_err": abs_err,
               "max_rel_err": rel_err, "tolerance_vs_plain": 1e-5,
               "max_abs_err_vs_f64": float((x.double() - x64).abs().max()),
               "within_f64_bar": f64_ok,
               "tolerance_vs_f64": "rtol 1e-3, atol 1e-4"}
        if name == "main_dominant":
            main = rec
            v3 = v[..., None]
            rec["ms"] = cuda_ms(lambda: chol.chol_solve(a, v), 3, 20)
            rec["plain_ms"] = cuda_ms(lambda: chol.chol_solve_plain(a, v),
                                      1, 3)
            rec["library_ms"] = cuda_ms(lambda: torch.linalg.solve(a, v3),
                                        3, 20)
            rec["library_call"] = "torch.linalg.solve(A, v)"
            rec["library_two_calls_ms"] = cuda_ms(
                lambda: torch.cholesky_solve(
                    v3, torch.linalg.cholesky(a), upper=False), 3, 20)
            rec["library_two_calls"] = ("torch.linalg.cholesky, then "
                                        "torch.cholesky_solve")
            rec["bound_ms"], rec["bound_by"] = chol_solve_bound_ms(
                b, n, chol.NB)
            # the sweep alone: cholesky_rt on the same input
            rec["sweep_ms"] = cuda_ms(lambda: chol.cholesky_rt(a), 3, 20)
            check_kernels_per_call(torch, rec,
                                   lambda: chol.chol_solve(a, v), 2)
        emit(rec)
        if not (rel_err <= 1e-5 and f64_ok):
            raise RuntimeError(f"chol_solve {name}: {rec}")
    return main


def phase_small_reference(torch):
    """The card's scores against the CPU plain path on a small model built
    from the same numpy seed (the port's own reference)."""
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    wavs = np.random.default_rng(5).uniform(-0.2, 0.2, (4, 8000)).astype(
        np.float32)
    enroll = np.random.default_rng(6).standard_normal((5, 16))
    scores = {}
    for dev in ("cpu", "cuda"):
        params = random_iv_plda_params(np.random.default_rng(99), 64, 72, 32,
                                       16, device=dev)
        model = IvPlda(params)
        model.set_enrollment([str(i) for i in range(5)], enroll)
        with torch.no_grad():
            scores[dev] = model.score(torch.tensor(wavs, device=dev)).cpu()
    err = float((scores["cuda"] - scores["cpu"]).abs().max())
    ok = bool(torch.allclose(scores["cuda"], scores["cpu"], rtol=1e-3,
                             atol=5e-3))
    emit({"phase": "small_reference", "max_abs_err": err,
          "tolerance": "rtol 1e-3, atol 5e-3", "ok": ok})
    if not ok:
        raise RuntimeError(f"card vs CPU scores differ by {err}")


def gmm_bounds(b, t, d, c):
    """Least times (ms) of the three GMM kernels on this card: each input
    read once and each output written once at the memory rate, against
    their products at the type's peak rate plus their elementwise work at
    the f32 rate.  fused_loglike's f32-grade product on the tensor cores is
    six bf16 products (the three-piece split, as Precision.HIGHEST on the
    TPU); ``fused_loglike_f32_simt`` is the same function as one f32
    product on the CUDA cores.  Returns {name: (bound_ms, bound_by)}."""
    n, p = b * t, d * (d + 1) // 2
    f = d + p

    def bound(nbytes, bf16_flops, f32_flops):
        return _bound(nbytes / HBM_BYTES_PER_S * 1e3,
                      (bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS) * 1e3)

    return {
        # x, quad_proj, gconsts in; loglike out.  aug products + the GEMM
        "fused_loglike": bound(4 * (n * d + f * c + c + n * c),
                               6 * 2.0 * n * f * c, n * p),
        "fused_loglike_f32_simt": bound(4 * (n * d + f * c + c + n * c), 0,
                                        n * p + 2.0 * n * f * c),
        # x, proj16, gconsts in; zeroth, first, posts16 out.  loglike and
        # first products; aug products, softmax (max, exp, sum, divide)
        "stats_fwd": bound(4 * n * d + 2 * f * c + 4 * c + 4 * b * c
                           + 4 * b * c * d + 2 * n * c,
                           2.0 * n * f * c + 2.0 * n * c * d,
                           n * p + 4.0 * n * c),
        # x, proj16, posts16, dzeroth, dfirst in; dx out.  dp, daug and the
        # direct products; the softmax VJP and the chain rule
        "stats_bwd": bound(4 * n * d + 2 * f * c + 2 * n * c + 4 * b * c
                           + 4 * b * c * d + 4 * n * d,
                           2.0 * n * f * c + 4.0 * n * c * d,
                           4.0 * n * c + 4.0 * n * p),
    }


GMM_SHAPES = [(64, 300, 72, 2048), (3, 37, 10, 200), (2, 130, 6, 64)]
# slice_defended_iv's shape: FeCo at ratio 0.5 leaves 150 of the 300
# frames, so the GMM kernels take 64 x 150 = 9,600 rows there
DEFENDED_GMM_SHAPE = (64, 150, 72, 2048)
# slice_siren_iv's shapes: 16 utterances x 25 particles = 400 waves of 300
# frames a particle evaluation (stats_fwd at 120,000 rows, cholesky_rt at
# B = 400), 16 x 300 = 4,800 rows on the exact guard and the final
# re-evaluation (fused_loglike)
SIREN_STATS_SHAPE = (400, 300, 72, 2048)
SIREN_GUARD_SHAPE = (16, 300, 72, 2048)


def gmm_case(shape):
    """The case name of a GMM kernel check at ``shape``."""
    if shape == GMM_SHAPES[0]:
        return "main"
    if shape in (SIREN_STATS_SHAPE, SIREN_GUARD_SHAPE):
        return "siren"
    return "defended" if shape == DEFENDED_GMM_SHAPE else "ragged"


def gmm_inputs(torch, b, t, d, c):
    """The GMM kernels' inputs at one shape: a random GMM from a numpy seed,
    x and the backward's cotangents from a torch seed, all on the card."""
    from speakerguard_tpu_torch.models.gmm import random_gmm
    p = random_gmm(np.random.default_rng(c + d), c, d, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(t)
    x = torch.randn((b, t, d), generator=g, device="cuda")
    dz = torch.randn((b, c), generator=g, device="cuda")
    df = torch.randn((b, c, d), generator=g, device="cuda")
    return p, x, dz, df


def stats_fwd_check(x, got, want, pf):
    """(zeroth, first, posts16) ``got`` against the plain ``want`` and the
    plain f32 posteriors ``pf``, at the tolerances phase_gmm_kernels gives
    for stats_fwd.  Returns the record, "ok" included."""
    from speakerguard_tpu_torch.ops.gmm_stats import _bf
    (z, f, post16), (zw, fw, pw) = got, want
    z_err = float((z - zw).abs().max())
    p_ok = bool(((post16.float() - pf).abs()
                 <= (2.0 ** -8 + 1e-3) * pf.abs() + 1e-37).all())
    flips = (post16.float() - pw.float()).abs()
    f_bound = flips.mT @ _bf(x).abs() + 1e-5 * float(fw.abs().max())
    f_ok = bool(((f - fw).abs() <= f_bound).all())
    return {"zeroth_max_abs_err": z_err,
            "zeroth_tolerance": 1e-4 * float(zw.abs().max()),
            "first_max_abs_err": float((f - fw).abs().max()),
            "posts16_share_differing": float((flips > 0).float().mean()),
            "posts16_within_half_ulp_plus_1e-3": p_ok,
            "first_within_flip_bound": f_ok,
            "ok": z_err <= 1e-4 * float(zw.abs().max()) and p_ok and f_ok}


def phase_fused_loglike_launches(torch):
    """fused_loglike's two launches, each against its plain version on the
    same inputs, at the main, ragged, defended (DEFENDED_GMM_SHAPE) and
    Siren guard (SIREN_GUARD_SHAPE) shapes.  Tolerances, with their
    reasons:
      aug_split    torch.equal: the same roundings (the f32 aug value formed
                   once, then its three bf16 pieces), pad columns zero;
      split_gemm   2e-6 of the largest sum of absolute terms of
                   loglike_split_plain (its six products of |pieces|): the
                   same exact products summed in another order, on the
                   tensor cores against f32 GEMMs.
    The projection's split (proj_split_kmajor, plain torch) is timed with
    them; an odd C takes the GEMM epilogue's scalar stores.  Returns
    {launch: main-shape record}."""
    from speakerguard_tpu_torch.ops import gmm_loglike as L
    main = {}
    for b, t, d, c in GMM_SHAPES + [(2, 45, 7, 101), DEFENDED_GMM_SHAPE,
                                    SIREN_GUARD_SHAPE]:
        case = gmm_case((b, t, d, c))
        is_main = case == "main"
        p, x, _, _ = gmm_inputs(torch, b, t, d, c)
        f = L.aug_dim(d)
        shape = {"B": b, "T": t, "D": d, "C": c, "N": b * t, "F": f,
                 "F_pad": L.padded_k(f)}

        aug_s = L.aug_split(x)
        torch.cuda.synchronize()
        pieces = aug_s.reshape(b * t, 3, -1)
        recs = {"aug_split": {
            "equal_to_plain": bool(torch.equal(aug_s,
                                               L.augment_split_plain(x))),
            "pad_columns_zero": bool((pieces[..., f:] == 0).all()),
            "tolerance": "torch.equal"}}
        recs["aug_split"]["ok"] = (recs["aug_split"]["equal_to_plain"]
                                   and recs["aug_split"]["pad_columns_zero"])

        proj_s = L.proj_split_kmajor(p.quad_proj)
        ll = L.loglike_split_gemm(aug_s, proj_s, p.gconsts)
        torch.cuda.synchronize()
        ll_w = L.loglike_split_plain(aug_s, proj_s, p.gconsts)
        terms = float(L.loglike_split_plain(aug_s.abs(), proj_s.abs(),
                                            p.gconsts.abs()).max())
        err = float((ll - ll_w).abs().max())
        recs["split_gemm"] = {
            "max_abs_err": err, "max_abs_loglike": float(ll_w.abs().max()),
            "max_abs_terms": terms, "tolerance": 2e-6 * terms,
            "ok": err <= 2e-6 * terms}
        del ll_w

        if is_main:
            n = b * t
            timing = {
                "aug_split": lambda: L.aug_split(x),
                "proj_split": lambda: L.proj_split_kmajor(p.quad_proj),
                "split_gemm": lambda: L.loglike_split_gemm(aug_s, proj_s,
                                                           p.gconsts)}
            for name, fn in timing.items():
                recs.setdefault(name, {"ok": True})["ms"] = cuda_ms(fn, 3, 20)
            gemm = recs["split_gemm"]
            # counted over the six bf16 products
            gemm["tflops"] = 6 * 2.0 * n * f * c / gemm["ms"] / 1e9
            gemm["tflops_padded_k"] = (6 * 2.0 * n * L.padded_k(f) * c
                                       / gemm["ms"] / 1e9)
            gemm["bf16_peak_share"] = gemm["tflops"] * 1e12 / BF16_FLOPS
        for name, rec in recs.items():
            rec = {"phase": "launch", "kernel": "fused_loglike",
                   "launch": name, "case": case,
                   **shape, **rec}
            emit(rec)
            if not rec["ok"]:
                raise RuntimeError(f"fused_loglike {name} {shape}: {rec}")
            if is_main:
                main[name] = rec
    return main


def phase_stats_fwd_launches(torch):
    """stats_fwd's three launches, each against its plain version on the
    same inputs, at the main, ragged, defended (DEFENDED_GMM_SHAPE) and
    Siren particle (SIREN_STATS_SHAPE, 120,000 rows, timed too) shapes.
    Tolerances, with their reasons:
      aug16      torch.equal: the same roundings (x16, one rounding of the
                 exact f32 product x16 x16), pad columns zero;
      loglike    2e-6 of max (|aug16| |projK|^T + |gconsts|), the largest
                 sum of absolute terms: the GEMM and the plain f32 product
                 of the same bf16 operands sum exact products in another
                 order (tensor cores against FMA), and the sum-order error
                 scales with the absolute terms, not with the result;
      partials   on the kernel's own loglike: the tile maxima equal, the
                 sums of exp within 1e-5 relative (at most 256 terms of
                 2-ulp expf, summed in another order); padded columns
                 (C = 200, 64) must be left out, or a sum grows by
                 exp(gconsts - max) per pad column;
      normalise  on the plain loglike and partials, at stats_fwd's
                 tolerances (phase_gmm_kernels).
    Returns ({launch: main-shape record}, {launch: Siren-shape record})."""
    from speakerguard_tpu_torch.ops import gmm_stats as S
    by_case = {"main": {}, "siren": {}}
    for b, t, d, c in GMM_SHAPES + [DEFENDED_GMM_SHAPE, SIREN_STATS_SHAPE]:
        case = gmm_case((b, t, d, c))
        timed = case in by_case
        p, x, _, _ = gmm_inputs(torch, b, t, d, c)
        proj16 = p.quad_proj.to(torch.bfloat16)
        f = d + d * (d + 1) // 2
        shape = {"B": b, "T": t, "D": d, "C": c, "N": b * t, "F": f,
                 "F_pad": S.padded_k(f)}

        aug16 = S.augment16_padded(x)
        torch.cuda.synchronize()
        aug_w = S.augment16_padded_plain(x)
        recs = {"aug16": {"equal_to_plain": bool(torch.equal(aug16, aug_w)),
                          "pad_columns_zero": bool(
                              (aug16[:, f:] == 0).all()),
                          "tolerance": "torch.equal"}}
        recs["aug16"]["ok"] = (recs["aug16"]["equal_to_plain"]
                               and recs["aug16"]["pad_columns_zero"])

        projk = S.proj_kmajor(proj16)
        ll, part = S.loglike_partials(aug16, projk, p.gconsts)
        torch.cuda.synchronize()
        ll_w, part_w = S.loglike_partials_plain(aug16, projk, p.gconsts)
        terms = float((aug16.float().abs() @ projk.float().abs().T
                       + p.gconsts.abs()).max())
        err = float((ll - ll_w).abs().max())
        recs["loglike_gemm"] = {
            "max_abs_err": err, "max_abs_loglike": float(ll_w.abs().max()),
            "max_abs_terms": terms, "tolerance": 2e-6 * terms,
            "ok": err <= 2e-6 * terms}

        part_k = S.tile_partials(ll)  # plain partials of the kernel's loglike
        s_rel = float(((part[..., 1] - part_k[..., 1]).abs()
                       / part_k[..., 1]).max())
        m_equal = bool(torch.equal(part[..., 0], part_k[..., 0]))
        m, s = S.combine_partials(part)
        lse_rel = float(((m + torch.log(s))[:, 0]
                         - torch.logsumexp(ll, dim=-1)).abs().max()
                        / torch.logsumexp(ll, dim=-1).abs().max())
        recs["partials"] = {
            "max_equal": m_equal, "sum_max_rel_err": s_rel,
            "sum_tolerance_rel": 1e-5,
            "combined_max_equal_row_max": bool(torch.equal(
                m[:, 0], ll.amax(dim=-1))),
            "combined_lse_rel_err": lse_rel,
            "ok": m_equal and s_rel <= 1e-5}

        got = S.normalise_stats(ll_w, part_w, x)
        torch.cuda.synchronize()
        m_w, s_w = S.combine_partials(part_w)
        recs["normalise"] = stats_fwd_check(
            x, got, S.normalise_stats_plain(ll_w, part_w, x),
            (torch.exp(ll_w - m_w) / s_w).reshape(b, t, c))

        if timed:
            n = b * t
            timing = {
                "aug16": lambda: S.augment16_padded(x),
                "proj_kmajor": lambda: S.proj_kmajor(proj16),
                "loglike_gemm": lambda: S.loglike_partials(aug16, projk,
                                                           p.gconsts),
                "normalise": lambda: S.normalise_stats(ll, part, x)}
            for name, fn in timing.items():
                recs.setdefault(name, {"ok": True})["ms"] = cuda_ms(fn, 3, 20)
            gemm = recs["loglike_gemm"]
            gemm["tflops"] = 2.0 * n * f * c / gemm["ms"] / 1e9
            gemm["tflops_padded_k"] = (2.0 * n * S.padded_k(f) * c
                                       / gemm["ms"] / 1e9)
            gemm["bf16_peak_share"] = gemm["tflops"] * 1e12 / BF16_FLOPS
        for name, rec in recs.items():
            rec = {"phase": "launch", "kernel": "stats_fwd", "launch": name,
                   "case": case, **shape, **rec}
            emit(rec)
            if not rec["ok"]:
                raise RuntimeError(f"stats_fwd {name} {shape}: {rec}")
            if timed:
                by_case[case][name] = rec
    return by_case["main"], by_case["siren"]


# stats_bwd's launches also at a C that is no multiple of 8: the posts16
# loads go scalar and both TMA operands are zero-padded copies
BWD_SHAPES = GMM_SHAPES + [(2, 45, 6, 100), DEFENDED_GMM_SHAPE]


def phase_stats_bwd_launches(torch):
    """stats_bwd's three launches, each against its plain version on the
    same inputs (posts16 from stats_fwd, each launch fed the kernel output
    of the one before), at BWD_SHAPES (main, ragged and defended).
    Tolerances, with their reasons:
      dl      bf16(dl) within one bf16 ulp of the plain f32 dl (2^-7 of
              the value, or bf16's subnormal spacing 2^-133 where a tiny
              posterior makes dl subnormal), plus posts x 1e-5 of
              the row's largest sum of absolute terms of dp (|dz| + |x16|
              |df16|): the kernel adds dp's exact products in another
              order (tensor cores) and the row sum sum_c posts dp as
              sum_c posts dz + x16 . (posts16 . df16), summed over c first,
              so where dp - sum_c posts dp cancels, f32 round-off moves dl
              by that much before its one rounding;
      direct  2e-6 of the largest sum of absolute terms (|posts16| |df16|):
              exact products summed in another order; each side's error
              against a float64 product is reported beside it;
      daug    2e-6 of the largest sum of absolute terms (|dl16| |proj16|^T),
              the loglike GEMM's bar;
      chain   1e-6 of the largest sum of absolute terms (chain_sum_plain of
              |daug|, |x|, |direct|): f32 sums of D + 3 terms in another
              order.
    Returns {launch: main-shape record}."""
    from speakerguard_tpu_torch.ops import gmm_stats as S
    main = {}
    for b, t, d, c in BWD_SHAPES:
        case = gmm_case((b, t, d, c))
        is_main = case == "main"
        p, x, dz, df = gmm_inputs(torch, b, t, d, c)
        proj16 = p.quad_proj.to(torch.bfloat16)
        f = d + d * (d + 1) // 2
        shape = {"B": b, "T": t, "D": d, "C": c, "N": b * t, "F": f}
        post16 = S.stats_fwd(x, proj16, p.gconsts)[2]

        dl16, direct = S.dl_direct(x, post16, dz, df)
        torch.cuda.synchronize()
        dl_w = S.dl_plain(x, post16, dz, df)
        _, direct_w = S.dl_direct_plain(x, post16, dz, df)
        posts = post16.reshape(b * t, c).float()
        dp_terms = (dz.abs()[:, None, :] + S._bf(x).abs()
                    @ S._bf(df).abs().mT).amax(dim=-1).reshape(-1, 1)
        got = dl16.float()
        ulp = torch.clamp_min(
            2.0 ** -7 * torch.maximum(dl_w.abs(), got.abs()), 2.0 ** -133)
        bound = ulp + 1e-5 * posts * dp_terms
        dl_err = (got - dl_w).abs()
        recs = {"dl": {
            "max_abs_err": float(dl_err.max()),
            "max_err_over_bound": float((dl_err / bound).max()),
            "share_differing_from_rounded_plain": float(
                (dl16 != dl_w.to(torch.bfloat16)).float().mean()),
            "pad_columns_zero": True,
            "tolerance": ("one bf16 ulp + posts 1e-5 max_c(|dz| + "
                          "|x16||df16|)"),
            "ok": bool((dl_err <= bound).all())}}
        if dl16.stride(0) > c:  # the (N, ldc) buffer's pad columns
            pad = dl16.as_strided((b * t, dl16.stride(0) - c),
                                  (dl16.stride(0), 1), c)
            recs["dl"]["pad_columns_zero"] = bool((pad == 0).all())
            recs["dl"]["ok"] &= recs["dl"]["pad_columns_zero"]
        terms = float((post16.float() @ S._bf(df).abs()).max())
        err = float((direct - direct_w).abs().max())
        ref = (post16.double() @ S._bf(df).double()).reshape(-1, d)
        recs["direct"] = {"max_abs_err": err, "max_abs_terms": terms,
                          "tolerance": 2e-6 * terms,
                          "max_abs_err_f64": float((direct - ref).abs().max()),
                          "plain_max_abs_err_f64": float(
                              (direct_w - ref).abs().max()),
                          "ok": err <= 2e-6 * terms}
        del ref

        daug = S.daug_gemm(dl16, proj16)
        torch.cuda.synchronize()
        daug_w = S.daug_plain(dl16, proj16)
        terms = float((dl16.float().abs() @ proj16.float().abs().T).max())
        err = float((daug - daug_w).abs().max())
        recs["daug_gemm"] = {"max_abs_err": err,
                             "max_abs_daug": float(daug_w.abs().max()),
                             "max_abs_terms": terms,
                             "tolerance": 2e-6 * terms,
                             "ok": err <= 2e-6 * terms}
        del daug_w

        dx = S.chain_sum(daug, x, direct)
        torch.cuda.synchronize()
        dx_w = S.chain_sum_plain(daug, x, direct)
        terms = float(S.chain_sum_plain(daug.abs(), x.abs(),
                                        direct.abs()).max())
        err = float((dx - dx_w).abs().max())
        recs["chain_sum"] = {"max_abs_err": err,
                             "max_abs_dx": float(dx_w.abs().max()),
                             "max_abs_terms": terms,
                             "tolerance": 1e-6 * terms,
                             "ok": err <= 1e-6 * terms}
        del dx_w

        if is_main:
            n = b * t
            timing = {
                "dl": lambda: S.dl_direct(x, post16, dz, df),
                "daug_gemm": lambda: S.daug_gemm(dl16, proj16),
                "chain_sum": lambda: S.chain_sum(daug, x, direct)}
            for name, fn in timing.items():
                recs[name]["ms"] = cuda_ms(fn, 3, 20)
            gemm = recs["daug_gemm"]
            gemm["tflops"] = 2.0 * n * f * c / gemm["ms"] / 1e9
            gemm["bf16_peak_share"] = gemm["tflops"] * 1e12 / BF16_FLOPS
            gemm["library_ms"] = cuda_ms(lambda: torch.mm(
                dl16, proj16.T, out_dtype=torch.float32), 3, 20)
            gemm["library_call"] = ("torch.mm(dl16, proj16.T, "
                                    "out_dtype=torch.float32)")
        for name, rec in recs.items():
            rec = {"phase": "launch", "kernel": "stats_bwd", "launch": name,
                   "case": case, **shape, **rec}
            emit(rec)
            if not rec["ok"]:
                raise RuntimeError(f"stats_bwd {name} {shape}: {rec}")
            if is_main:
                main[name] = rec
    return main


def phase_gmm_kernels(torch):
    """fused_loglike, stats_fwd and stats_bwd against their plain versions
    at the main path's shape (64 x 300 frames, D=72, C=2048), at
    slice_defended_iv's (64 x 150 frames: 9,600 rows, T split over the
    64-frame tile as 64 + 64 + 22) and at ragged ones (T not a multiple of
    the 64-frame tile, C not a multiple of the 64-component tile, small
    D), each at the same bars.  Tolerances, with their reasons:
      fused_loglike  2e-6 of max |loglike|: sums of 2700 exact products in
                     another order (six bf16 products of the three-piece
                     split, each stage's tensor-core partial sum added in
                     f32); and its error against a float64 product of the
                     same f32 aug values at most twice the plain f32
                     product's;
      stats_fwd      posts16 within half a bf16 ulp (its rounding) + 1e-3
                     relative of the plain f32 posteriors: the kernel's
                     tensor-core sums of 2700 bf16 products differ from the
                     plain f32 GEMM's by ~1e-4 at loglikes of a few hundred,
                     which moves a posterior by ~1e-4 of itself; zeroth to
                     1e-4 of its scale; first to 1e-5 of its scale plus
                     exactly what the posts16 differences move;
      stats_bwd      on stats_fwd's own posts16: 1e-5 of the gradient's
                     scale on all but 5% of entries, 2e-3 on the rest, where
                     bf16(dl) flips by one ulp (2^-7) at a rounding boundary.
    The main and defended cases are timed (kernel, plain, library) and
    bounded.  Returns ({name: main-shape record}, {name: defended-shape
    record})."""
    from speakerguard_tpu_torch.ops import gmm_loglike as L
    from speakerguard_tpu_torch.ops import gmm_stats as S
    by_case = {"main": {}, "defended": {}}
    for b, t, d, c in GMM_SHAPES + [DEFENDED_GMM_SHAPE]:
        case = gmm_case((b, t, d, c))
        timed = case in by_case
        p, x, dz, df = gmm_inputs(torch, b, t, d, c)
        proj16 = p.quad_proj.to(torch.bfloat16)
        bounds = gmm_bounds(b, t, d, c)
        shape = {"B": b, "T": t, "D": d, "C": c}

        out = L.fused_loglike(x, p.quad_proj, p.gconsts)
        torch.cuda.synchronize()
        want = L.fused_loglike_plain(x, p.quad_proj, p.gconsts)
        err = float((out - want).abs().max())
        tol = 2e-6 * float(want.abs().max())
        ref = (L.augment_plain(x).double() @ p.quad_proj.double()
               + p.gconsts.double())
        err64 = float((out.double() - ref).abs().max())
        plain64 = float((want.double() - ref).abs().max())
        del ref
        recs = {"fused_loglike": {
            "max_abs_err": err, "max_abs_loglike": float(want.abs().max()),
            "tolerance": tol, "max_abs_err_f64": err64,
            "plain_max_abs_err_f64": plain64,
            "tolerance_f64": "2 x the plain f32 product's",
            "ok": err <= tol and err64 <= 2.0 * plain64}}

        z, f, post16 = S.stats_fwd(x, proj16, p.gconsts)
        torch.cuda.synchronize()
        rec = stats_fwd_check(x, (z, f, post16),
                              S.stats_fwd_plain(x, proj16, p.gconsts),
                              S.posteriors_plain(x, proj16, p.gconsts))
        recs["stats_fwd"] = {"max_abs_err": max(rec["zeroth_max_abs_err"],
                                                rec["first_max_abs_err"]),
                             **rec}

        dx = S.stats_bwd(x, proj16, post16, dz, df)
        torch.cuda.synchronize()
        dw = S.stats_bwd_plain(x, proj16, post16, dz, df)
        scale = float(dw.abs().max())
        e = (dx - dw).abs()
        share = float((e > 1e-5 * scale).float().mean())
        recs["stats_bwd"] = {"max_abs_err": float(e.max()),
                             "max_err_over_scale": float(e.max()) / scale,
                             "share_over_1e-5": share,
                             "ok": share <= 0.05
                             and float(e.max()) <= 2e-3 * scale}

        if timed:
            aug = L.augment_plain(x)
            aug16 = S._bf(x)
            rows, cols = L.packed_indices(d, x.device)
            aug16 = torch.cat([aug16, S._bf(aug16[..., rows]
                                            * aug16[..., cols])], dim=-1)
            aug16 = aug16.reshape(-1, aug16.shape[-1]).to(torch.bfloat16)
            aug = aug.reshape(-1, aug.shape[-1])
            g16 = p.gconsts.to(torch.bfloat16)
            timing = {
                "fused_loglike": (
                    lambda: L.fused_loglike(x, p.quad_proj, p.gconsts),
                    lambda: L.fused_loglike_plain(x, p.quad_proj, p.gconsts),
                    lambda: torch.addmm(p.gconsts, aug, p.quad_proj)),
                "stats_fwd": (
                    lambda: S.stats_fwd(x, proj16, p.gconsts),
                    lambda: S.stats_fwd_plain(x, proj16, p.gconsts),
                    lambda: torch.addmm(g16, aug16, proj16)),
                "stats_bwd": (
                    lambda: S.stats_bwd(x, proj16, post16, dz, df),
                    lambda: S.stats_bwd_plain(x, proj16, post16, dz, df),
                    lambda: torch.addmm(g16, aug16, proj16)),
            }
            for name, (kern, plain, lib) in timing.items():
                recs[name]["ms"] = cuda_ms(kern, 2, 10)
                recs[name]["plain_ms"] = cuda_ms(plain, 1, 3)
                recs[name]["library_ms"] = cuda_ms(lib, 2, 10)
                recs[name]["library_call"] = (
                    "torch.addmm(gconsts, aug, quad_proj) on a pre-built "
                    + ("f32" if name == "fused_loglike" else "bf16")
                    + " aug (no single PyTorch call computes the fused "
                      "function)")
                recs[name]["bound_ms"], recs[name]["bound_by"] = bounds[name]
            recs["fused_loglike"]["bound_f32_simt_ms"] = bounds[
                "fused_loglike_f32_simt"][0]
            # the same product on the 64-column-padded operands the port's
            # GEMM takes (2752 columns: rows 16-byte aligned)
            aug16_pad = S.augment16_padded_plain(x)
            projk = S.proj_kmajor(proj16)
            recs["stats_fwd"]["library_aligned_ms"] = cuda_ms(
                lambda: torch.addmm(g16, aug16_pad, projk.T), 2, 10)
            recs["stats_fwd"]["library_aligned_call"] = (
                "torch.addmm(gconsts, aug16 padded to 2752 columns, projK^T)")
            # the backward's dominant product on its own operands
            dl16 = S.dl_direct_plain(x, post16, dz, df)[0]
            recs["stats_bwd"]["library_bwd_product_ms"] = cuda_ms(
                lambda: torch.mm(dl16, proj16.T, out_dtype=torch.float32),
                2, 10)
            recs["stats_bwd"]["library_bwd_product_call"] = (
                "torch.mm(bf16(dl), proj16.T, out_dtype=torch.float32)")
            del aug, aug16, aug16_pad, dl16
        for name, rec in recs.items():
            rec = {"phase": "kernel", "kernel": name, "case": case, **shape,
                   **rec}
            emit(rec)
            if not rec["ok"]:
                raise RuntimeError(f"{name} {shape}: {rec}")
            if timed:
                by_case[case][name] = rec
    return by_case["main"], by_case["defended"]


def build_model(torch, params, fast, loglike_kernel, enroll,
                spd_solver="cholesky_rt"):
    from speakerguard_tpu_torch.models.iv_plda import IvPlda
    model = IvPlda(params, fast=fast, loglike_kernel=loglike_kernel,
                   spd_solver=spd_solver)
    model.set_enrollment([f"spk{i}" for i in range(len(enroll))], enroll)
    return model


def run_slice(torch, name, model, x, wrappers, expected, profile_dir,
              fields, batch=64, iters=10, task="CSI-E", fgsm=False):
    """make_decision, then PGD-`iters` on ``model``, after a 1-iteration
    warm-up (first-use costs: lazy module loading, allocator growth,
    library handles); with ``fgsm``, then FGSM (eps 0.002) on the same
    batch and labels, whose success vector must equal a re-decision of its
    adversarial waves (make_decision is the exact path).  Every wrapper's
    counts are set to 0 just before the run and read just after;
    ``expected`` maps names to launch counts, and every plain count must
    stay 0.  ``fields`` are the model's own fields of the record (its name
    and shapes); ``task`` names the task.  Returns the launch counts."""
    from speakerguard_tpu_torch.attacks import FGSM, PGD
    t0 = time.perf_counter()
    PGD(model, task="CSI", epsilon=0.002, step_size=0.0004, max_iter=1,
        loss="Entropy").attack(x, torch.zeros(batch, dtype=torch.long,
                                              device="cuda"), rng=0)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        decisions, scores = model.make_decision(x)
    torch.cuda.synchronize()
    decide_s = time.perf_counter() - t0
    labels = decisions.long()
    atk = PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
              max_iter=iters, loss="Entropy")
    t0 = time.perf_counter()
    adver, success = atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    pgd_s = time.perf_counter() - t0
    fgsm_rec = None
    if fgsm:
        t0 = time.perf_counter()
        f_adver, f_success = FGSM(model, task="CSI", epsilon=0.002,
                                  loss="Entropy").attack(x, labels, rng=0)
        torch.cuda.synchronize()
        fgsm_s = time.perf_counter() - t0
        with torch.no_grad():
            redecided = (model.make_decision(f_adver)[0] != labels).tolist()
        fgsm_rec = {"seconds": fgsm_s,
                    "asr_pct": 100.0 * sum(f_success) / batch,
                    "finite": bool(torch.isfinite(f_adver).all()),
                    "within_eps": float((f_adver - x).abs().max())
                    <= 0.002 + 1e-6,
                    "matches_exact_redecision": redecided == f_success,
                    "success": [int(v) for v in f_success]}
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}

    finite = bool(torch.isfinite(scores).all() and torch.isfinite(adver).all())
    within = float((adver - x).abs().max()) <= 0.002 + 1e-6
    fast = model.fast_path
    rec = {"phase": name, **fields, "task": task,
           "speakers": model.num_spks, "batch": batch,
           "samples": int(x.shape[1]), "attack": "PGD", "iterations": iters,
           "fast_path": None if fast is None else vars(fast),
           "warmup_pgd1_s": warmup_s, "make_decision_s": decide_s,
           "pgd_s": pgd_s, "pgd_ms_per_iter": pgd_s * 1e3 / iters,
           "pgd_utts_per_s": batch / pgd_s,
           "asr_pct": 100.0 * sum(success) / batch,
           "scores_shape": list(scores.shape), "finite": finite,
           "within_eps": within,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "success": [int(s) for s in success],
           "launches": launches, "launches_expected": expected,
           "plain_calls": plain}
    if fgsm_rec is not None:
        rec["fgsm"] = fgsm_rec
    emit(rec)
    if not (finite and within
            and list(scores.shape) == [batch, model.num_spks]):
        raise RuntimeError(f"{name} output check failed: {rec}")
    if fgsm_rec is not None and not (fgsm_rec["finite"]
                                     and fgsm_rec["within_eps"]
                                     and fgsm_rec["matches_exact_redecision"]):
        raise RuntimeError(f"{name} FGSM check failed: {fgsm_rec}")
    wrong = {k: v for k, v in expected.items() if launches[k] != v}
    if wrong or any(plain.values()):
        raise RuntimeError(f"{name}: launches {launches} (expected "
                           f"{expected}), plain calls {plain}")
    if profile_dir:
        profile_one_iteration(torch, model, x, labels, profile_dir, name)
    return launches


def phase_slices(torch, wrappers, profile_dir):
    """The five slices on one set of full-width weights (the models share
    the parameter tensors).  Each expects a launch count of every wrapper,
    0 where it names none.  Returns {slice: launch counts}."""
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.iv_plda import random_iv_plda_params
    batch, length, n_spk, iters = 64, 48000, 10, 10
    t0 = time.perf_counter()
    params = random_iv_plda_params(np.random.default_rng(0), 2048, 72, 600,
                                   200, device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    exact = build_model(torch, params, FastPath(enabled=False), False,
                        np.zeros((n_spk, 200), np.float32))
    with torch.no_grad():
        enroll = exact.embedding(torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0})
    # one solve per exact evaluation (make_decision, the final one) and per
    # iteration; chol_solve's backward solves once more
    evals = 1 + iters + 1
    chol_only = {"cholesky_rt": evals}
    slices = [  # (name, FastPath, loglike_kernel, spd_solver, launches)
        ("slice", FastPath(enabled=False), False, "cholesky_rt", chol_only),
        ("slice_fast_kernels", FastPath(gmm_topk=0, stats_kernel=True), True,
         "cholesky_rt", {"cholesky_rt": evals, "stats_fwd": iters,
                         "stats_bwd": iters, "fused_loglike": 2}),
        ("slice_fast_default", FastPath(), False, "cholesky_rt", chol_only),
        ("slice_chol_dinv", FastPath(), False, "cholesky_rt_dinv",
         {"cholesky_rt_dinv": evals}),
        ("slice_chol_solve", FastPath(), False, "chol_solve",
         {"chol_solve": evals + iters}),
    ]
    out, models = {}, {}
    for name, fast, kernel, solver, launches in slices:
        model = build_model(torch, params, fast, kernel, enroll, solver)
        expected = {k: launches.get(k, 0) for k in wrappers}
        fields = {"model": "iv_plda", "C": 2048, "D": 72, "IV": 600,
                  "R": 200, "loglike_kernel": kernel, "spd_solver": solver}
        out[name] = run_slice(torch, name, model, x, wrappers, expected,
                              profile_dir, fields, batch, iters)
        models[name] = model
    return out, models, x


def phase_xv_slices(torch, wrappers, profile_dir):
    """Full-width xv-PLDA (TDNN_SPEC widths, 30 ceps, a 512-dim x-vector,
    LDA to 150, weights from numpy seed 0), 10 speakers enrolled from waves,
    task CSI-E, 512 utterances of 3 s; make_decision, then PGD (eps 0.002,
    step 0.0004, Entropy) on three fast-path configurations.  No hand
    kernel lies on this path: every wrapper's launch count is 0.  Returns
    {slice: launch counts}."""
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.tdnn import TDNN_SPEC
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    batch, length, n_spk = 512, 48000, 10
    t0 = time.perf_counter()
    params = random_xv_plda_params(np.random.default_rng(0), device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    with torch.no_grad():
        enroll = XvPlda(params, fast=FastPath(enabled=False)).embedding(
            torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "setup_xv", "seconds": time.perf_counter() - t0})
    fields = {"model": "xv_plda", "tdnn_spec": TDNN_SPEC, "num_ceps": 30,
              "emb_dim": 512, "R": 150}
    slices = [  # (name, FastPath, PGD iterations)
        ("slice_xv", FastPath(), 100),
        ("slice_xv_fast_f32", FastPath(tdnn_bf16_act=False), 10),
        ("slice_xv_exact", FastPath(enabled=False), 10),
    ]
    out = {}
    for name, fast, iters in slices:
        model = XvPlda(params, fast=fast)
        model.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
        out[name] = run_slice(torch, name, model, x, wrappers,
                              {k: 0 for k in wrappers}, profile_dir, fields,
                              batch, iters)
    return out


def phase_audionet_slices(torch, wrappers, profile_dir):
    """Full-width AudioNet (CONV_SPEC, 32 log-mel bins, n_fft 1024, 10
    classes, weights from numpy seed 0 as the bench draws them), task
    CSI-NE, 512 utterances of 3 s (T=300 frames); make_decision, then PGD
    (eps 0.002, step 0.0004, Entropy) and FGSM (eps 0.002) on the same
    batch: PGD-100 with FastPath() (bf16 DFT, bf16 CNN), PGD-10 on the
    exact path.  No hand kernel lies on this path: every wrapper's launch
    count is 0.  Returns {slice: launch counts}."""
    from speakerguard_tpu_torch.models.audionet import (CONV_SPEC, AudioNet,
                                                        init_audionet)
    from speakerguard_tpu_torch.models.base import FastPath
    batch, length = 512, 48000
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    pair = init_audionet(rng, 10, device="cuda")
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "setup_audionet", "seconds": time.perf_counter() - t0})
    fields = {"model": "audionet", "conv_spec": CONV_SPEC, "n_mels": 32,
              "n_fft": 1024, "classes": 10}
    slices = [  # (name, FastPath, PGD iterations)
        ("slice_audionet", FastPath(), 100),
        ("slice_audionet_exact", FastPath(enabled=False), 10),
    ]
    out = {}
    for name, fast, iters in slices:
        out[name] = run_slice(torch, name, AudioNet(*pair, fast=fast), x,
                              wrappers, {k: 0 for k in wrappers},
                              profile_dir, fields, batch, iters,
                              task="CSI-NE", fgsm=True)
    return out


def phase_audionet_small_reference(torch):
    """The card's AudioNet scores and embeddings against the CPU's, exact
    path, on weights from the same numpy seed whose BN running stats are
    first set on the CPU to the batch statistics of a few waves (so that
    the scores are O(1) and differ between waves), at the CPU tests'
    score bar."""
    from speakerguard_tpu_torch.models.audionet import (AudioNet,
                                                        audionet_logits,
                                                        init_audionet)
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.ops.logmel import audionet_logmel
    params, state = init_audionet(np.random.default_rng(99), 10,
                                  device="cpu")
    feats = audionet_logmel(torch.tensor(np.random.default_rng(7).uniform(
        -0.3, 0.3, (8, 16000)).astype(np.float32)))
    for _ in range(40):
        state = audionet_logits(params, state, feats, train=True)[2]
    wavs = np.random.default_rng(5).uniform(-0.3, 0.3, (4, 16000)).astype(
        np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = AudioNet(params, state, fast=FastPath(enabled=False)).to(dev)
        with torch.no_grad():
            scores, emb = model.forward(torch.tensor(wavs, device=dev),
                                        return_emb=True)
        out[dev] = (scores.cpu(), emb.cpu())
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    emb_err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    ok = bool(torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                             atol=2e-3)
              and torch.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                                 atol=2e-3))
    emit({"phase": "audionet_small_reference", "max_abs_err": err,
          "max_abs_score": float(out["cpu"][0].abs().max()),
          "emb_max_abs_err": emb_err,
          "tolerance": "rtol 1e-4, atol 2e-3 (scores and embeddings)",
          "ok": ok})
    if not ok:
        raise RuntimeError(f"card vs CPU AudioNet scores differ by {err}, "
                           f"embeddings by {emb_err}")


def run_cw2_slice(torch, name, model, x, labels, wrappers, expected,
                  expected_cwinf, profile_dir, fast, bss=3, iters=50):
    """make_decision, then CW2 on task SV (``bss`` binary-search steps of
    ``iters`` Adam steps, early stop off, initial const 10; ``fast`` scores
    its inner loop on the fast path), then CWinf (eps 0.002, step 0.0004,
    10 iterations) on the same batch, after a warm-up CW2 of one step.
    The counts are set to 0 just before make_decision and read just after
    CW2 (``expected``), then set to 0 again around CWinf
    (``expected_cwinf``); every plain count must stay 0.  Hard checks:
    finite audio, the (B, 1) score shape, CW2's success equal to an exact
    re-decision of its audio, each failed wave returned unchanged, CWinf
    within eps.  Returns the CW2 run's launch counts."""
    from speakerguard_tpu_torch.attacks import CW2, CWinf
    batch = x.shape[0]
    kw = dict(task="SV", stop_early=False, initial_const=10.0, fast=fast)
    t0 = time.perf_counter()
    CW2(model, binary_search_steps=1, max_iter=1, **kw).attack(x, labels,
                                                               rng=0)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        _, scores = model.make_decision(x)
    atk = CW2(model, binary_search_steps=bss, max_iter=iters, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adver, success = atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    cw2_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    with torch.no_grad():
        redecided = (model.make_decision(adver)[0] != labels).tolist()
    unchanged = all(torch.equal(adver[i], x[i])
                    for i, s in enumerate(success) if not s)

    for w in wrappers.values():
        w.reset_counts()
    t0 = time.perf_counter()
    c_adver, c_success = CWinf(model, task="SV", epsilon=0.002,
                               step_size=0.0004, max_iter=10).attack(
        x, labels, rng=0)
    torch.cuda.synchronize()
    cwinf_s = time.perf_counter() - t0
    c_launches = {k: w.launches for k, w in wrappers.items()}
    c_plain = {k: w.plain_calls for k, w in wrappers.items()}
    with torch.no_grad():
        c_redecided = (model.make_decision(c_adver)[0] != labels).tolist()

    evals = bss * (iters + 1)
    finite = bool(torch.isfinite(scores).all() and torch.isfinite(adver).all()
                  and torch.isfinite(c_adver).all())
    within = float((c_adver - x).abs().max()) <= 0.002 + 1e-6
    fp = model.fast_path
    rec = {"phase": name, "model": "iv_plda", "C": 2048, "D": 72, "IV": 600,
           "R": 200, "loglike_kernel": model.loglike_kernel,
           "dither": model.mfcc_config.dither, "task": "SV",
           "threshold": model.threshold, "batch": batch,
           "samples": int(x.shape[1]),
           "labels_accept_reject": [int((labels == 0).sum()),
                                    int((labels == -1).sum())],
           "attack": "CW2", "cw2_fast": fast, "binary_search_steps": bss,
           "max_iter": iters, "inner_evaluations": evals,
           "fast_path": None if fp is None else vars(fp),
           "warmup_cw2_s": warmup_s, "cw2_s": cw2_s,
           "cw2_ms_per_inner_iter": cw2_s * 1e3 / evals,
           "cw2_utts_per_s": batch / cw2_s,
           "asr_pct": 100.0 * sum(success) / batch,
           "peak_mem_gib": peak, "scores_shape": list(scores.shape),
           "finite": finite,
           "matches_exact_redecision": redecided == success,
           "failed_waves_unchanged": unchanged,
           "success": [int(v) for v in success],
           "consts": atk.consts.tolist(),
           "launches": launches, "launches_expected": expected,
           "plain_calls": plain,
           "cwinf": {"seconds": cwinf_s, "ms_per_iter": cwinf_s * 1e3 / 10,
                     "asr_pct": 100.0 * sum(c_success) / batch,
                     "within_eps": within,
                     "matches_exact_redecision": c_redecided == c_success,
                     "success": [int(v) for v in c_success],
                     "launches": c_launches,
                     "launches_expected": expected_cwinf,
                     "plain_calls": c_plain}}
    emit(rec)
    if not (finite and within and list(scores.shape) == [batch, 1]
            and rec["matches_exact_redecision"] and unchanged):
        raise RuntimeError(f"{name} output check failed: {rec}")
    wrong = {k: v for k, v in expected.items() if launches[k] != v}
    wrong.update({f"cwinf_{k}": v for k, v in expected_cwinf.items()
                  if c_launches[k] != v})
    if wrong or any(plain.values()) or any(c_plain.values()):
        raise RuntimeError(f"{name}: launches {launches}, CWinf "
                           f"{c_launches} (expected {expected}, "
                           f"{expected_cwinf}), plain calls {plain}, "
                           f"{c_plain}")
    if profile_dir:
        profile_one_iteration(
            torch, model, x, labels, profile_dir, name,
            CW2(model, binary_search_steps=1, max_iter=1, **kw),
            "one CW2 binary-search step of one Adam step (two inner "
            "evaluations)" + (" and the exact re-verification" if fast
                              else ""))
    return launches


def phase_cw2_slices(torch, wrappers, profile_dir):
    """CW2 and CWinf on iv-PLDA SV, BASELINE.json config 3, on the full-width
    weights of phase_slices (drawn again from the same numpy seed, so that
    the phases between hold no iv-PLDA weights): one speaker enrolled from
    a wave, 64
    utterances of 3 s, the threshold the median of their clean scores
    (exact, dither 0) and their clean decisions as labels.  slice_cw2_sv
    runs the exact path without dither; slice_cw2_sv_fast the fused stats
    and loglike kernels with the default dither.  Returns {slice: launch
    counts}."""
    import dataclasses
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC
    batch, length = 64, 48000
    params = random_iv_plda_params(np.random.default_rng(0), 2048, 72, 600,
                                   200, device="cuda")
    rng = np.random.default_rng(2)
    enroll_wav = torch.tensor(rng.uniform(-0.3, 0.3, (1, length)).astype(
        np.float32), device="cuda")
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    no_dither = dataclasses.replace(IV_PLDA_MFCC, dither=0.0)

    def build(fast, kernel, mfcc, threshold=None, enroll=None):
        model = IvPlda(params, threshold=threshold, mfcc_config=mfcc,
                       fast=fast, loglike_kernel=kernel)
        if enroll is not None:
            model.set_enrollment(["spk0"], enroll)
        return model

    with torch.no_grad():
        enroll = build(FastPath(enabled=False), False,
                       no_dither).embedding(enroll_wav)
        clean = build(FastPath(enabled=False), False, no_dither,
                      enroll=enroll).score(x)[:, 0]
    threshold = float(np.median(clean.cpu().numpy()))
    labels = torch.where(clean > threshold, 0, -1).long()
    evals = 3 * 51
    slices = [  # (name, FastPath, loglike_kernel, mfcc, CW2 fast, counts)
        ("slice_cw2_sv", FastPath(enabled=False), False, no_dither, False,
         {"cholesky_rt": 1 + evals}, {"cholesky_rt": 11}),
        ("slice_cw2_sv_fast", FastPath(gmm_topk=0, stats_kernel=True), True,
         IV_PLDA_MFCC, True,
         {"cholesky_rt": 2 + evals, "fused_loglike": 2, "stats_fwd": evals,
          "stats_bwd": evals},
         {"cholesky_rt": 11, "fused_loglike": 1, "stats_fwd": 10,
          "stats_bwd": 10}),
    ]
    out = {}
    for name, fast, kernel, mfcc, cw2_fast, counts, cwinf_counts in slices:
        model = build(fast, kernel, mfcc, threshold, enroll)
        out[name] = run_cw2_slice(
            torch, name, model, x, labels, wrappers,
            {k: counts.get(k, 0) for k in wrappers},
            {k: cwinf_counts.get(k, 0) for k in wrappers}, profile_dir,
            cw2_fast)
    return out


def phase_nes_kernels(torch, chol):
    """stats_fwd and cholesky_rt at the shapes that one NES iteration of
    slice_fakebob_osi_fast gives them: 16 utterances x 51 evaluation points
    = 816 waves, 816 x 300 = 244,800 frames; 816 matrices of 600 x 600.
    Each against its plain version at the bars of its main-shape row
    (stats_fwd_check; cholesky_rt's blocked residual and plain error at
    1e-5, f32 and bf16_updates), with CUDA-event ms and the bound.
    Returns {kernel: record of the f32 case}."""
    from speakerguard_tpu_torch.ops import gmm_stats as S
    b, t, d, c = 16 * 51, 300, 72, 2048
    p, x, _, _ = gmm_inputs(torch, b, t, d, c)
    proj16 = p.quad_proj.to(torch.bfloat16)
    got = S.stats_fwd(x, proj16, p.gconsts)
    torch.cuda.synchronize()
    rec = stats_fwd_check(x, got, S.stats_fwd_plain(x, proj16, p.gconsts),
                          S.posteriors_plain(x, proj16, p.gconsts))
    del got
    rec = {"phase": "kernel", "kernel": "stats_fwd", "case": "nes",
           "B": b, "T": t, "D": d, "C": c, "rows": b * t,
           "max_abs_err": max(rec["zeroth_max_abs_err"],
                              rec["first_max_abs_err"]), **rec,
           "ms": cuda_ms(lambda: S.stats_fwd(x, proj16, p.gconsts), 2, 10),
           "plain_ms": cuda_ms(
               lambda: S.stats_fwd_plain(x, proj16, p.gconsts), 1, 2)}
    rec["bound_ms"], rec["bound_by"] = gmm_bounds(b, t, d, c)["stats_fwd"]
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"stats_fwd at the NES shape: {rec}")
    out = {"stats_fwd": rec}
    del p, x, proj16
    torch.cuda.empty_cache()

    n, tol = 600, 1e-5
    a = spd_batch(torch, "dominant", b, n, seed=n, dtype=torch.float32)
    for upd in (False, True):
        got = chol.cholesky_rt(a, bf16_updates=upd)
        torch.cuda.synchronize()
        want = chol.cholesky_rt_plain(a, bf16_updates=upd)
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        lower_zero = bool(torch.all(torch.tril(got, -1) == 0))
        resid = chol.blocked_residual(a, got, upd)
        rec = {"phase": "kernel", "kernel": "cholesky_rt",
               "case": "nes_bf16_updates" if upd else "nes_f32",
               "input": "dominant", "shape": [b, n, n], "bf16_updates": upd,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance_vs_plain": tol, "blocked_residual": resid,
               "tolerance_residual": tol, "strictly_lower_zero": lower_zero,
               "ms": cuda_ms(lambda: chol.cholesky_rt(a, upd), 3, 20),
               "plain_ms": cuda_ms(lambda: chol.cholesky_rt_plain(a, upd),
                                   1, 2)}
        rec["bound_ms"], rec["bound_by"] = chol_bound_ms(b, n, 4, upd,
                                                         chol.NB)
        emit(rec)
        del got, want
        if not (lower_zero and resid <= tol and rel_err <= tol):
            raise RuntimeError(f"cholesky_rt at the NES shape: {rec}")
        out.setdefault("cholesky_rt", rec)
    del a
    torch.cuda.empty_cache()
    return out


def bounded_noise(torch, gen, limit, draws):
    """A FAKEBOB ``noise_fn``: torch.randn from ``gen`` (the default's
    draws), appending each iteration index to ``draws`` and raising once
    ``limit`` is reached, since threshold estimation has no end of its own
    while the model's threshold is out of reach."""
    def fn(it, shape):
        if it >= limit:
            raise RuntimeError(f"threshold estimation took over {limit} "
                               "NES steps")
        draws.append(it)
        return torch.randn(shape, generator=gen, device="cuda")
    return fn


def recording_exact_scores(model, batch):
    """Wraps ``model.score`` so that the generator state of each exact
    (``fast`` off) call on ``batch`` waves is recorded; returns that list.
    FAKEBOB's last such call re-scores its returned audio, and replaying
    the state there draws the same dither.  ``del model.score`` undoes
    it."""
    states, score = [], model.score

    def recording(x, *args, rng=None, fast=False, **kw):
        if not fast and rng is not None and x.shape[0] == batch:
            states.append(rng.get_state())
        return score(x, *args, rng=rng, fast=fast, **kw)

    model.score = recording
    return states


def run_estimation(torch, model, waves, wrappers, fast):
    """FAKEBOB.estimate_threshold (task OSI, eps 0.002, step 0.1, 50
    samples, max lr 0.001) on ``waves``, with its own counts.  Returns
    (estimate, NES bodies, noise draws, seconds, launches, plain calls)."""
    from speakerguard_tpu_torch.attacks import FAKEBOB
    gen = torch.Generator(device="cuda").manual_seed(1)
    draws = []
    atk = FAKEBOB(model, task="OSI", epsilon=0.002, samples_per_draw=50,
                  samples_per_draw_batch_size=50, max_lr=0.001, fast=fast,
                  noise_fn=bounded_noise(torch, gen, 500, draws))
    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = atk.estimate_threshold(waves, step=0.1, rng=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (est, atk.estimate_bodies, len(draws), seconds,
            {k: w.launches for k, w in wrappers.items()},
            {k: w.plain_calls for k, w in wrappers.items()})


def run_fakebob_slice(torch, name, model, x, labels, wrappers, task,
                      threshold, atk_kw, expected_fn, fields, profile_dir):
    """make_decision, then FAKEBOB(``atk_kw``) on ``model`` with the attack
    threshold ``threshold``, after a warm-up attack of one NES iteration.
    The counts are set to 0 just before make_decision and read just after
    the attack; ``expected_fn(atk)`` gives the expected counts from the
    attack's NES bodies and guard evaluations, and every plain count must
    stay 0.  Hard checks: finite audio and scores within eps, the score
    shape, and the success vector equal to the margin loss (< 0) of an
    exact re-evaluation of the returned audio under ``threshold``, with
    the dither draw of the attack's own re-evaluation where it made one.
    Returns (launch counts, record)."""
    from speakerguard_tpu_torch.attacks import FAKEBOB
    from speakerguard_tpu_torch.attacks.losses import margin_loss
    batch = x.shape[0]
    kw = dict(threshold=threshold, task=task, **atk_kw)
    t0 = time.perf_counter()
    FAKEBOB(model, **{**kw, "max_iter": 0}).attack(x, labels, rng=1)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        _, scores = model.make_decision(x)
    atk = FAKEBOB(model, **kw)
    states = recording_exact_scores(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adver, success = atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    attack_s = time.perf_counter() - t0
    del model.score
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    with torch.no_grad():
        gen = None
        if states:
            gen = torch.Generator(device="cuda")
            gen.set_state(states[-1])
        loss = margin_loss(model.score(adver, rng=gen), labels, task=task,
                           threshold=threshold, clip_max=False)
        decisions = model.make_decision(adver)[0]
    expected = {k: 0 for k in wrappers}
    expected.update(expected_fn(atk))
    iters = atk.last_executed_iters
    finite = bool(torch.isfinite(scores).all()
                  and torch.isfinite(adver).all())
    within = float((adver - x).abs().max()) <= atk.epsilon + 1e-6
    fp = model.fast_path
    rec = {"phase": name, **fields, "task": task, "threshold": threshold,
           "model_threshold": model.threshold,
           "dither": model.mfcc_config.dither, "speakers": model.num_spks,
           "batch": batch, "samples": int(x.shape[1]),
           "labels_rejected": int((labels == -1).sum()),
           "attack": "FAKEBOB", **atk_kw,
           "fast_path": None if fp is None else vars(fp),
           "nes_waves_per_iter": batch * (atk.samples_per_draw // 2 * 2 + 1),
           "warmup_1_iter_s": warmup_s, "attack_s": attack_s,
           "executed_iters": iters, "guard_evals": atk.last_guard_evals,
           "ms_per_nes_iter": attack_s * 1e3 / iters,
           "utts_per_s": batch / attack_s,
           "asr_pct": 100.0 * sum(success) / batch,
           "model_decision_asr_pct": 100.0 * float(
               (decisions != labels).float().mean()),
           "peak_mem_gib": peak, "scores_shape": list(scores.shape),
           "finite": finite, "within_eps": within,
           "matches_exact_reevaluation": (loss < 0).tolist() == success,
           "reevaluation_dither_replayed": bool(states),
           "success": [int(v) for v in success],
           "launches": launches, "launches_expected": expected,
           "plain_calls": plain}
    if not (finite and within and rec["matches_exact_reevaluation"]
            and list(scores.shape) == [batch, model.num_spks]):
        emit(rec)
        raise RuntimeError(f"{name} output check failed")
    wrong = {k: v for k, v in expected.items() if launches[k] != v}
    if wrong or any(plain.values()):
        emit(rec)
        raise RuntimeError(f"{name}: launches {launches} (expected "
                           f"{expected}), plain calls {plain}")
    if profile_dir:
        profile_one_iteration(
            torch, model, x, labels, profile_dir, name,
            FAKEBOB(model, **{**kw, "max_iter": 0}),
            "one NES iteration" + (" with the exact evaluations of the "
                                   "guard and the final re-scoring"
                                   if atk.fast else ""))
    return launches, rec


def phase_fakebob_slices(torch, wrappers, profile_dir):
    """FAKEBOB, BASELINE.json config 4.  iv-PLDA on the full-width weights
    of phase_slices (drawn again from numpy seed 0), 10 speakers enrolled
    from waves, task OSI, 16 utterances of 3 s; the model threshold is the
    median of their clean max scores (exact, dither 0), the labels their
    clean decisions (8 speakers, 8 rejects), so one untargeted run has
    both branches.
      slice_fakebob_osi        exact path, dither 0: estimate_threshold on
                               the 2 rejected waves nearest below the
                               threshold (counted apart: cholesky_rt 2 +
                               NES bodies), then FAKEBOB-30 (fast=False) at
                               that estimate: cholesky_rt 1 + NES bodies.
      slice_fakebob_osi_fast   the default dither, FastPath(gmm_topk=0,
                               stats_kernel=True), loglike_kernel=True,
                               FAKEBOB(fast=True) at the same estimate:
                               stats_fwd = NES bodies, fused_loglike =
                               1 + guard evaluations + 1, cholesky_rt =
                               their sum; the estimation again on this
                               model (stats_fwd 0, fused_loglike =
                               cholesky_rt: it ignores fast).
      slice_fakebob_xv         xv-PLDA at full width, FastPath(), 10
                               speakers, task CSI, batch 128, FAKEBOB-5
                               (fast=True) with the 51 points in 3 chunks
                               of 17: every hand-kernel count 0.
    Returns {slice: launch counts}."""
    import dataclasses
    from speakerguard_tpu_torch.models.base import FastPath, decide
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    from speakerguard_tpu_torch.ops.kaldi_mfcc import IV_PLDA_MFCC
    batch, length, n_spk = 16, 48000, 10
    t0 = time.perf_counter()
    params = random_iv_plda_params(np.random.default_rng(0), 2048, 72, 600,
                                   200, device="cuda")
    rng = np.random.default_rng(3)
    enroll_wavs = torch.tensor(rng.uniform(-0.3, 0.3, (n_spk, length))
                               .astype(np.float32), device="cuda")
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    no_dither = dataclasses.replace(IV_PLDA_MFCC, dither=0.0)

    def build(fast, kernel, mfcc, threshold=None, enroll=None):
        model = IvPlda(params, threshold=threshold, mfcc_config=mfcc,
                       fast=fast, loglike_kernel=kernel)
        if enroll is not None:
            model.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
        return model

    with torch.no_grad():
        enroll = build(FastPath(enabled=False), False,
                       no_dither).embedding(enroll_wavs)
        clean = build(FastPath(enabled=False), False, no_dither,
                      enroll=enroll).score(x)
    clean_max = clean.max(dim=1).values
    threshold = float(np.median(clean_max.cpu().numpy()))
    labels = decide(clean, threshold)[0].long()
    below = torch.where(clean_max <= threshold, threshold - clean_max,
                        float("inf"))
    est_waves = x[torch.argsort(below)[:2]]
    torch.cuda.synchronize()
    emit({"phase": "setup_fakebob", "seconds": time.perf_counter() - t0,
          "threshold": threshold, "clean_max_scores": clean_max.tolist(),
          "labels": labels.tolist()})
    fields = {"model": "iv_plda", "C": 2048, "D": 72, "IV": 600, "R": 200}
    atk_kw = dict(epsilon=0.002, max_iter=30, samples_per_draw=50,
                  samples_per_draw_batch_size=50, max_lr=0.001,
                  stop_early=False)
    out = {}

    # the exact path, dither 0
    model = build(FastPath(enabled=False), False, no_dither, threshold,
                  enroll)
    est, bodies, draws, est_s, est_l, est_p = run_estimation(
        torch, model, est_waves, wrappers, False)
    est_expected = {k: 0 for k in wrappers}
    est_expected["cholesky_rt"] = len(est_waves) + bodies
    if est is None:
        raise RuntimeError("slice_fakebob_osi: no usable estimation wave")
    launches, rec = run_fakebob_slice(
        torch, "slice_fakebob_osi", model, x, labels, wrappers, "OSI", est,
        {**atk_kw, "fast": False},
        lambda a: {"cholesky_rt": 1 + a.last_executed_iters},
        {**fields, "loglike_kernel": False}, profile_dir)
    rec["estimation"] = {"waves": len(est_waves), "estimate": est,
                         "model_threshold": threshold, "nes_bodies": bodies,
                         "noise_draws": draws, "seconds": est_s,
                         "launches": est_l, "launches_expected": est_expected,
                         "plain_calls": est_p}
    emit(rec)
    if est_l != est_expected or any(est_p.values()):
        raise RuntimeError(f"slice_fakebob_osi estimation: launches {est_l} "
                           f"(expected {est_expected}), plain {est_p}")
    out["slice_fakebob_osi"] = launches
    del model
    torch.cuda.empty_cache()

    # the fused stats and loglike kernels, the default dither
    model = build(FastPath(gmm_topk=0, stats_kernel=True), True,
                  IV_PLDA_MFCC, threshold, enroll)

    def fast_counts(a):
        exact = 1 + a.last_guard_evals + 1
        return {"stats_fwd": a.last_executed_iters, "fused_loglike": exact,
                "cholesky_rt": a.last_executed_iters + exact}

    launches, rec = run_fakebob_slice(
        torch, "slice_fakebob_osi_fast", model, x, labels, wrappers, "OSI",
        est, {**atk_kw, "fast": True}, fast_counts,
        {**fields, "loglike_kernel": True}, profile_dir)
    est2, bodies, draws, est_s, est_l, est_p = run_estimation(
        torch, model, est_waves, wrappers, True)
    est_expected = {k: 0 for k in wrappers}
    est_expected.update(fused_loglike=len(est_waves) + bodies,
                        cholesky_rt=len(est_waves) + bodies)
    rec["estimation"] = {"waves": len(est_waves), "estimate": est2,
                         "estimate_exact_slice": est,
                         "model_threshold": threshold, "nes_bodies": bodies,
                         "noise_draws": draws, "seconds": est_s,
                         "launches": est_l, "launches_expected": est_expected,
                         "plain_calls": est_p}
    emit(rec)
    if est_l != est_expected or any(est_p.values()):
        raise RuntimeError(f"slice_fakebob_osi_fast estimation: launches "
                           f"{est_l} (expected {est_expected}), plain "
                           f"{est_p}")
    out["slice_fakebob_osi_fast"] = launches
    del model, params, enroll, x, est_waves
    torch.cuda.empty_cache()

    # xv-PLDA, CSI, the JAX package's FAKEBOB batch
    batch = 128
    xparams = random_xv_plda_params(np.random.default_rng(0), device="cuda")
    rng = np.random.default_rng(4)
    enroll_wavs = torch.tensor(rng.uniform(-0.3, 0.3, (n_spk, length))
                               .astype(np.float32), device="cuda")
    x = torch.tensor(rng.uniform(-0.3, 0.3, (batch, length)).astype(
        np.float32), device="cuda")
    with torch.no_grad():
        enroll = XvPlda(xparams, fast=FastPath(enabled=False)).embedding(
            enroll_wavs)
    model = XvPlda(xparams, fast=FastPath())
    model.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
    with torch.no_grad():
        labels = model.make_decision(x)[0].long()
    launches, rec = run_fakebob_slice(
        torch, "slice_fakebob_xv", model, x, labels, wrappers, "CSI", None,
        dict(epsilon=0.002, max_iter=5, samples_per_draw=50,
             samples_per_draw_batch_size=17, max_lr=0.001, stop_early=False,
             fast=True),
        lambda a: {}, {"model": "xv_plda", "num_ceps": 30, "R": 150,
                       "nes_chunks": [17, 17, 17]}, profile_dir)
    emit(rec)
    out["slice_fakebob_xv"] = launches
    return out


def bf16_ulp(torch, a):
    """The spacing of bf16 numbers at |a| (8 significant bits)."""
    a = a.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def within_top_ulp(torch, got, ref):
    """Every entry within one bf16 ulp of the largest entry of ``ref``."""
    top = ref.float().abs().max()
    return bool((got.float() - ref.float()).abs().max()
                <= bf16_ulp(torch, top))


def phase_xv_blocks(torch):
    """Each TDNN fast block on the card at the headline shape (batch 512,
    T=300 frames, (B, T, C)) against its plain version ``fast_block_plain``
    (the block's float32 steps and roundings around float64 convolutions,
    its backward on the block's own ReLU mask) on the same input and
    cotangent, at the bars of tests/test_torch_tdnn.py: f32 round-off for
    _BlockFast (its backward is one bf16 GEMM with a float32 output); for
    _BlockFastBf16 (bf16 GEMMs) each output within one bf16 ulp plus one
    ulp of the conv output times the BN scale (the block rounds the conv
    output before the bias) plus the float32 floor of 1e-5 of the largest
    entry, and the cotangent within one ulp of its largest entry.  Each
    stats pool against autograd of the exact pooling (its residual is
    bf16, so its cotangent within one bf16 ulp of the largest entry).
    CUDA-event ms of each block's forward and backward, and of the exact
    layer's forward + backward under autograd."""
    from speakerguard_tpu_torch.models import tdnn as T
    tp = T.random_tdnn(np.random.default_rng(0), device="cuda")
    b, t = 512, 300
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []

    def rel(a, ref):
        a, ref = a.detach().float(), ref.detach().float()
        return float((a - ref).abs().max() / ref.abs().max())

    def grad_of(fn, x, g):
        xk = x.detach().clone().requires_grad_(True)
        out = fn(xk)
        return out, xk, lambda: torch.autograd.grad(out, xk, g,
                                                    retain_graph=True)[0]

    cin = 30
    for i, (k, dil, cout) in enumerate(T.TDNN_SPEC):
        t_out = t - (k - 1) * dil
        bn = tp.bn_tdnn[i]
        args = (tp.conv_w[i], tp.conv_b[i], bn.mean, bn.var, dil)
        for bf16 in (False, True):
            dt = torch.bfloat16 if bf16 else torch.float32
            block = T._BlockFastBf16 if bf16 else T._BlockFast
            x = torch.randn(b, t, cin, device="cuda", generator=gen).to(dt)
            g = torch.randn(b, t_out, cout, device="cuda",
                            generator=gen).to(dt)
            out, xk, bwd = grad_of(lambda xx: block.apply(xx, *args), x, g)
            dx = bwd()
            mask = out.grad_fn.saved_tensors[0]
            p_out, p_dx = T.fast_block_plain(x, *args, g, bf16, mask)
            if bf16:
                # one ulp of the output plus one of the conv output (at
                # most (|out| + one ulp) / s + |b - mean|) times the BN
                # scale s, plus the float32 sums' absolute round-off floor
                s_bn = torch.rsqrt(bn.var + T.BN_EPS)
                mag = torch.maximum(out.detach().float().abs(),
                                    p_out.float().abs())
                conv_mag = ((mag + bf16_ulp(torch, mag)) / s_bn
                            + (args[1] - bn.mean).abs())
                tol = (bf16_ulp(torch, mag) + s_bn * bf16_ulp(torch, conv_mag)
                       + 1e-5 * p_out.float().abs().max())
                excess = (out.detach().float() - p_out.float()).abs() - tol
                out_ok = bool((excess <= 0).all())
                dx_ok = within_top_ulp(torch, dx, p_dx)
            else:
                out_ok = bool(torch.allclose(
                    out, p_out, rtol=1e-5,
                    atol=1e-5 * float(p_out.abs().max())))
                dx_ok = bool(torch.allclose(
                    dx, p_dx, rtol=1e-5,
                    atol=1e-5 * float(p_dx.abs().max())))

            def exact_layer():
                xf = x.float().requires_grad_(True)
                ref = T._bn(torch.relu(T._conv1d(xf, args[0], args[1], dil)),
                            bn)
                return torch.autograd.grad(ref, xf, g.float())[0]

            rec = {"phase": "xv_blocks",
                   "block": "_BlockFastBf16" if bf16 else "_BlockFast",
                   "layer": i + 1, "shape": [b, t, cin],
                   "out_rel_err": rel(out, p_out),
                   "out_max_excess": float(excess.max()) if bf16 else None,
                   "dx_rel_err": rel(dx, p_dx),
                   "bars": ("output within one bf16 ulp plus one ulp of the "
                            "conv output times the BN scale plus 1e-5 of "
                            "the largest; dx within one ulp of the largest"
                            if bf16
                            else "rtol 1e-5, atol 1e-5 of max"),
                   "ok": out_ok and dx_ok,
                   "fwd_ms": cuda_ms(lambda: block.apply(xk, *args), 2, 10),
                   "bwd_ms": cuda_ms(bwd, 2, 10),
                   "exact_fwd_bwd_ms": cuda_ms(exact_layer, 2, 10)}
            emit(rec)
            if not rec["ok"]:
                bad.append(rec)
            del out, xk, bwd, dx, mask, p_out, p_dx
        cin = cout
    for bf16 in (False, True):
        dt = torch.bfloat16 if bf16 else torch.float32
        pool = T._StatsPoolFastBf16 if bf16 else T._StatsPoolFast
        x = torch.randn(b, 270, cin, device="cuda", generator=gen).to(dt)
        g = torch.randn(b, 2 * cin, device="cuda", generator=gen)
        out, xk, bwd = grad_of(pool.apply, x, g)
        dx = bwd()
        ref, _, ref_bwd = grad_of(
            lambda xx: torch.cat(T._mean_std(xx.float()), dim=-1), x, g)
        ref_dx = ref_bwd()
        rec = {"phase": "xv_blocks", "block": pool.__name__,
               "shape": [b, 270, cin], "out_rel_err": rel(out, ref),
               "dx_rel_err": rel(dx, ref_dx),
               "bars": "rtol 1e-5 (out); dx within one bf16 ulp of the "
                       "largest entry",
               "fwd_ms": cuda_ms(lambda: pool.apply(xk), 2, 10),
               "bwd_ms": cuda_ms(bwd, 2, 10)}
        rec["ok"] = (rec["out_rel_err"] <= 1e-5
                     and within_top_ulp(torch, dx, ref_dx))
        emit(rec)
        if not rec["ok"]:
            bad.append(rec)
    if bad:
        raise RuntimeError(f"xv_blocks: {len(bad)} blocks off their bars: "
                           f"{bad}")


def phase_xv_small_reference(torch):
    """The card's xv-PLDA scores against the CPU plain path on a model
    built from the same numpy seed, at the CPU tests' score bar."""
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    wavs = np.random.default_rng(5).uniform(-0.2, 0.2, (4, 16000)).astype(
        np.float32)
    enroll = np.random.default_rng(6).standard_normal((5, 150))
    scores = {}
    for dev in ("cpu", "cuda"):
        model = XvPlda(random_xv_plda_params(np.random.default_rng(99),
                                             device=dev))
        model.set_enrollment([str(i) for i in range(5)], enroll)
        with torch.no_grad():
            scores[dev] = model.score(torch.tensor(wavs, device=dev)).cpu()
    err = float((scores["cuda"] - scores["cpu"]).abs().max())
    ok = bool(torch.allclose(scores["cuda"], scores["cpu"], rtol=1e-4,
                             atol=2e-3))
    emit({"phase": "xv_small_reference", "max_abs_err": err,
          "tolerance": "rtol 1e-4, atol 2e-3", "ok": ok})
    if not ok:
        raise RuntimeError(f"card vs CPU xv scores differ by {err}")


def phase_defense_small_reference(torch):
    """Each deterministic defense of the defended slices on the card
    against the same call on the CPU (8 waves of 3 s): QT, BDR and MS
    equal (powers of two scale and quantise exactly; a median selects), AS,
    DS, LPF and BPF (float32 convolutions, TF32 off) within rtol 1e-5 and
    atol 2e-5 x max|x|; each also timed on the card at the slices' batch
    (512 x 3 s).  Then k-means (FeCo's Lloyd loop, L2 and cos) on the
    card against the CPU from the same initial frames on the xv MFCC of 16
    waves: the frames whose final assignment differs are counted (a near
    tie may flip one and the rest of its row follows), at least 3/4 of
    the rows must agree in every frame, and on those rows the compressed
    features hold to rtol 1e-4, atol 1e-5 x max|feat|."""
    from speakerguard_tpu_torch.defenses import frequency_domain as FD
    from speakerguard_tpu_torch.defenses import time_domain as TD
    from speakerguard_tpu_torch.ops import kmeans as km
    from speakerguard_tpu_torch.ops.kaldi_mfcc import XV_PLDA_MFCC, kaldi_mfcc
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.5, 0.5, (8, 48000)).astype(np.float32)
    big = torch.tensor(rng.uniform(-0.5, 0.5, (512, 48000)).astype(
        np.float32), device="cuda")
    cases = [("QT", TD.QT, {"param": 512}, True),
             ("BDR", TD.BDR, {"param": 8}, True),
             ("MS", TD.MS, {"param": 3}, True),
             ("AS", TD.AS, {"param": 3}, False),
             ("DS", FD.DS, {"param": 0.5}, False),
             ("LPF", FD.LPF, {}, False),
             ("BPF", FD.BPF, {"param": (50.0, 5000.0)}, False)]
    recs, bad = [], []
    scale = float(np.abs(x).max())
    for name, fn, kw, exact in cases:
        want = fn(torch.tensor(x), **kw)
        got = fn(torch.tensor(x, device="cuda"), **kw).cpu()
        err = float((got - want).abs().max())
        ok = (torch.equal(got, want) if exact else
              bool(torch.allclose(got, want, rtol=1e-5, atol=2e-5 * scale)))
        recs.append({"defense": name, "params": kw, "max_abs_err": err,
                     "bar": "equal" if exact else
                     "rtol 1e-5, atol 2e-5 x max|x|", "ok": ok,
                     "ms_512x48000": cuda_ms(lambda: fn(big, **kw), 2, 5)})
        if not ok:
            bad.append(name)
    feats = kaldi_mfcc(torch.tensor(rng.uniform(-0.3, 0.3, (16, 48000))
                                    .astype(np.float32)) * 32768.0,
                       XV_PLDA_MFCC)
    b, t, _ = feats.shape
    k = int(t * 0.2)
    idx = km.initial_indices(b, t, k, torch.Generator().manual_seed(3))
    big_feats = torch.randn((512, t, feats.shape[2]), device="cuda") * 5
    big_idx = km.initial_indices(512, t, k, None, "cuda")
    km_recs = []
    for distance in ("L2", "cos"):
        res = {}
        for dev in ("cpu", "cuda"):
            f = feats.to(dev)
            res[dev] = (km.kmeans_assign(f, idx.to(dev), 20, distance)
                        .argmax(-1).cpu(),
                        km.kmeans_compress_batch(f, 0.2, init_idx=idx.to(
                            dev), distance=distance).cpu())
        differ = res["cuda"][0] != res["cpu"][0]
        rows = ~differ.any(dim=1)
        got, want = res["cuda"][1][rows], res["cpu"][1][rows]
        ok = bool(int(rows.sum()) * 4 >= 3 * b and torch.allclose(
            got, want, rtol=1e-4, atol=1e-5 * float(feats.abs().max())))
        km_recs.append({
            "distance": distance, "shape": [b, t, int(feats.shape[2])],
            "K": k, "frames_assigned_differently": int(differ.sum()),
            "rows_agreeing": int(rows.sum()),
            "max_abs_err_agreeing_rows": float((got - want).abs().max()),
            "bar": "3/4 of the rows agree; rtol 1e-4, atol 1e-5 x "
                   "max|feat| on them", "ok": ok,
            "ms_512x300x30": cuda_ms(lambda: km.kmeans_compress_batch(
                big_feats, 0.2, init_idx=big_idx, distance=distance), 2, 5)})
        if not ok:
            bad.append(f"kmeans_{distance}")
    emit({"phase": "defense_small_reference", "defenses": recs,
          "kmeans": km_recs})
    if bad:
        raise RuntimeError(f"card vs CPU defenses differ: {bad}")


def run_defended_slice(torch, name, model, x, wrappers, expected, fields,
                       profile_dir, iters, eot):
    """make_decision on the defended ``model`` (its clean decisions are the
    labels), then PGD-``iters`` (eps 0.002, step 0.0004, Entropy) with
    ``eot`` EOT repeats, after a 1-iteration warm-up.  The counts are set
    to 0 just before make_decision and read just after the attack;
    ``expected`` maps names to launch counts, and every plain count must
    stay 0.  Hard checks: finite scores and audio within eps, the score
    shape, and the success vector equal to an exact re-decision of the
    returned audio through the defended model with the draws of the
    attack's final evaluation (its generator state replayed).  Returns
    the launch counts."""
    from speakerguard_tpu_torch.attacks import PGD
    batch = x.shape[0]

    def pgd(n):
        return PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
                   max_iter=n, loss="Entropy", EOT_size=eot)

    t0 = time.perf_counter()
    pgd(1).attack(x, torch.zeros(batch, dtype=torch.long, device="cuda"),
                  rng=1)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        decisions, scores = model.make_decision(x)
    torch.cuda.synchronize()
    decide_s = time.perf_counter() - t0
    labels = decisions.long()
    atk = pgd(iters)
    states = recording_exact_scores(model, batch)
    t0 = time.perf_counter()
    adver, success = atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    pgd_s = time.perf_counter() - t0
    del model.score
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    gen = torch.Generator(device="cuda")
    gen.set_state(states[-1])
    with torch.no_grad():
        redecided = (model.make_decision(adver, rng=gen)[0]
                     != labels).tolist()
    finite = bool(torch.isfinite(scores).all() and torch.isfinite(adver).all())
    within = float((adver - x).abs().max()) <= 0.002 + 1e-6
    fp = model.fast_path
    rec = {"phase": name, **fields, "task": "CSI-E",
           "speakers": model.num_spks, "batch": batch,
           "samples": int(x.shape[1]), "attack": "PGD", "iterations": iters,
           "eot": eot, "order": model.order,
           "fast_path": None if fp is None else vars(fp),
           "warmup_pgd1_s": warmup_s, "make_decision_s": decide_s,
           "pgd_s": pgd_s, "pgd_ms_per_iter": pgd_s * 1e3 / iters,
           "pgd_utts_per_s": batch / pgd_s,
           "asr_pct": 100.0 * sum(success) / batch,
           "clean_labels": {str(v): int((labels == v).sum())
                            for v in labels.unique().tolist()},
           "scores_shape": list(scores.shape), "finite": finite,
           "within_eps": within, "peak_mem_gib": peak,
           "exact_evaluations_recorded": len(states),
           "matches_exact_redecision": redecided == success,
           "success": [int(s) for s in success],
           "launches": launches, "launches_expected": expected,
           "plain_calls": plain}
    emit(rec)
    if not (finite and within and rec["matches_exact_redecision"]
            and len(states) == 1
            and list(scores.shape) == [batch, model.num_spks]):
        raise RuntimeError(f"{name} output check failed")
    wrong = {k: v for k, v in expected.items() if launches[k] != v}
    if wrong or any(plain.values()):
        raise RuntimeError(f"{name}: launches {launches} (expected "
                           f"{expected}), plain calls {plain}")
    if profile_dir:
        profile_one_iteration(
            torch, model, x, labels, profile_dir, name, pgd(1),
            f"one PGD iteration ({eot} EOT repeats) plus the exact final "
            "evaluation")
    return launches


def phase_defended_slices(torch, wrappers, profile_dir):
    """BASELINE.json config 5: PGD with EOT (BPDA through QT) against the
    defended model, task CSI-E, 10 speakers enrolled from clean waves, the
    defended model's clean decisions as labels.
      slice_defended_iv      iv-PLDA at full width (weights and waves of
                             phase_slices), batch 64 x 3 s, base
                             FastPath(gmm_topk=0, stats_kernel=True) and
                             loglike_kernel=True, QT("512")@0 +
                             FeCo("kmeans 0.5 L2")@1 (150 frames left, so
                             the stats kernels run at 64 x 150 rows),
                             PGD-10 with EOT 2: stats_fwd and stats_bwd
                             once per repeat (20), fused_loglike once per
                             exact evaluation (2: make_decision, the final
                             one), cholesky_rt once per repeat and exact
                             evaluation (22).
      slice_defended_xv      xv-PLDA at full width (weights and waves of
                             phase_xv_slices), batch 512 x 3 s, base
                             FastPath(), QT("512")@0 + FeCo("kmeans 0.2
                             L2")@1 (60 frames left), PGD-100 with EOT 2:
                             every hand-kernel count 0 (none on xv).
      slice_defended_xv_avg  the same xv batch, order "average" over
                             QT("512"), BPF("50 5000"), DS("0.5") and
                             MS("3"), all at flag 0 (four exact xv passes
                             a score), PGD-10 with EOT 1: every count 0.
    Returns {slice: launch counts}."""
    from speakerguard_tpu_torch.defenses.registry import parser_defense
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.defended import DefendedModel
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    from speakerguard_tpu_torch.models.tdnn import TDNN_SPEC
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    n_spk, length = 10, 48000
    out = {}

    def defended(base, names, params, flags, order="sequential"):
        defense, canonical = parser_defense(names, params, flags, order)
        return DefendedModel(base, defense, order), canonical

    # iv-PLDA through the GMM kernels
    t0 = time.perf_counter()
    params = random_iv_plda_params(np.random.default_rng(0), 2048, 72, 600,
                                   200, device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    with torch.no_grad():
        enroll = IvPlda(params, fast=FastPath(enabled=False)).embedding(
            torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (64, length)).astype(
        np.float32), device="cuda")
    base = IvPlda(params, fast=FastPath(gmm_topk=0, stats_kernel=True),
                  loglike_kernel=True)
    base.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
    model, canonical = defended(base, ["QT", "FeCo"],
                                ["512", "kmeans 0.5 L2"], [0, 1])
    torch.cuda.synchronize()
    emit({"phase": "setup_defended_iv", "seconds": time.perf_counter() - t0})
    iters, eot, exact_evals = 10, 2, 2
    expected = {k: 0 for k in wrappers}
    expected.update(stats_fwd=iters * eot, stats_bwd=iters * eot,
                    fused_loglike=exact_evals,
                    cholesky_rt=iters * eot + exact_evals)
    out["slice_defended_iv"] = run_defended_slice(
        torch, "slice_defended_iv", model, x, wrappers, expected,
        {"model": "iv_plda", "C": 2048, "D": 72, "IV": 600, "R": 200,
         "loglike_kernel": True, "defense": canonical, "frames": 300,
         "frames_after_feco": 150}, profile_dir, iters, eot)
    del model, base, params, enroll, x
    torch.cuda.empty_cache()

    # xv-PLDA at batch 512
    t0 = time.perf_counter()
    params = random_xv_plda_params(np.random.default_rng(0), device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    with torch.no_grad():
        enroll = XvPlda(params, fast=FastPath(enabled=False)).embedding(
            torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (512, length)).astype(
        np.float32), device="cuda")
    base = XvPlda(params, fast=FastPath())
    base.set_enrollment([f"spk{i}" for i in range(n_spk)], enroll)
    torch.cuda.synchronize()
    emit({"phase": "setup_defended_xv", "seconds": time.perf_counter() - t0})
    fields = {"model": "xv_plda", "tdnn_spec": TDNN_SPEC, "num_ceps": 30,
              "emb_dim": 512, "R": 150, "frames": 300}
    zero = {k: 0 for k in wrappers}
    model, canonical = defended(base, ["QT", "FeCo"],
                                ["512", "kmeans 0.2 L2"], [0, 1])
    out["slice_defended_xv"] = run_defended_slice(
        torch, "slice_defended_xv", model, x, wrappers, zero,
        {**fields, "defense": canonical, "frames_after_feco": 60},
        profile_dir, 100, 2)
    torch.cuda.empty_cache()
    model, canonical = defended(base, ["QT", "BPF", "DS", "MS"],
                                ["512", "50 5000", "0.5", "3"], [0, 0, 0, 0],
                                "average")
    out["slice_defended_xv_avg"] = run_defended_slice(
        torch, "slice_defended_xv_avg", model, x, wrappers, zero,
        {**fields, "defense": canonical}, profile_dir, 10, 1)
    return out


def phase_siren_kernels(torch, chol):
    """stats_fwd, cholesky_rt and fused_loglike at the shapes that
    slice_siren_iv gives them: a particle evaluation of 16 utterances x 25
    particles = 400 waves, 120,000 frames (stats_fwd), 400 matrices of
    600 x 600 (cholesky_rt, f32 and bf16_updates); the guard and the final
    re-evaluation on the 16 utterances, 4,800 frames (fused_loglike).
    Each against its plain version at the bars of its main-shape row, with
    CUDA-event ms of the kernel, the plain version and one library call,
    and the bound.  Returns {kernel: record of the f32 case}."""
    from speakerguard_tpu_torch.ops import gmm_loglike as L
    from speakerguard_tpu_torch.ops import gmm_stats as S
    out = {}
    b, t, d, c = SIREN_STATS_SHAPE
    p, x, _, _ = gmm_inputs(torch, b, t, d, c)
    proj16 = p.quad_proj.to(torch.bfloat16)
    got = S.stats_fwd(x, proj16, p.gconsts)
    torch.cuda.synchronize()
    rec = stats_fwd_check(x, got, S.stats_fwd_plain(x, proj16, p.gconsts),
                          S.posteriors_plain(x, proj16, p.gconsts))
    del got
    aug16 = S.augment16_padded_plain(x)
    projk = S.proj_kmajor(proj16)
    g16 = p.gconsts.to(torch.bfloat16)
    rec = {"phase": "kernel", "kernel": "stats_fwd", "case": "siren",
           "B": b, "T": t, "D": d, "C": c, "rows": b * t,
           "max_abs_err": max(rec["zeroth_max_abs_err"],
                              rec["first_max_abs_err"]), **rec,
           "ms": cuda_ms(lambda: S.stats_fwd(x, proj16, p.gconsts), 2, 10),
           "plain_ms": cuda_ms(
               lambda: S.stats_fwd_plain(x, proj16, p.gconsts), 1, 2),
           "library_ms": cuda_ms(
               lambda: torch.addmm(g16, aug16, projk.T), 2, 10),
           "library_call": "torch.addmm(gconsts, aug16 padded to 2752 "
                           "columns, projK^T) (no single PyTorch call "
                           "computes the fused function)"}
    rec["bound_ms"], rec["bound_by"] = gmm_bounds(b, t, d, c)["stats_fwd"]
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"stats_fwd at the Siren shape: {rec}")
    out["stats_fwd"] = rec
    del p, x, proj16, aug16, projk
    torch.cuda.empty_cache()

    n, tol = 600, 1e-5
    a = spd_batch(torch, "dominant", b, n, seed=n, dtype=torch.float32)
    for upd in (False, True):
        got = chol.cholesky_rt(a, bf16_updates=upd)
        torch.cuda.synchronize()
        want = chol.cholesky_rt_plain(a, bf16_updates=upd)
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        lower_zero = bool(torch.all(torch.tril(got, -1) == 0))
        resid = chol.blocked_residual(a, got, upd)
        rec = {"phase": "kernel", "kernel": "cholesky_rt",
               "case": "siren_bf16_updates" if upd else "siren_f32",
               "input": "dominant", "shape": [b, n, n], "bf16_updates": upd,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance_vs_plain": tol, "blocked_residual": resid,
               "tolerance_residual": tol, "strictly_lower_zero": lower_zero,
               "ms": cuda_ms(lambda: chol.cholesky_rt(a, upd), 3, 20),
               "plain_ms": cuda_ms(lambda: chol.cholesky_rt_plain(a, upd),
                                   1, 2),
               "library_ms": cuda_ms(
                   lambda: torch.linalg.cholesky(a, upper=True), 3, 20)}
        rec["bound_ms"], rec["bound_by"] = chol_bound_ms(b, n, 4, upd,
                                                         chol.NB)
        emit(rec)
        del got, want
        if not (lower_zero and resid <= tol and rel_err <= tol):
            raise RuntimeError(f"cholesky_rt at the Siren shape: {rec}")
        out.setdefault("cholesky_rt", rec)
    del a
    torch.cuda.empty_cache()

    b, t, d, c = SIREN_GUARD_SHAPE
    p, x, _, _ = gmm_inputs(torch, b, t, d, c)
    got = L.fused_loglike(x, p.quad_proj, p.gconsts)
    torch.cuda.synchronize()
    want = L.fused_loglike_plain(x, p.quad_proj, p.gconsts)
    aug = L.augment_plain(x)
    ref = aug.double() @ p.quad_proj.double() + p.gconsts.double()
    err = float((got - want).abs().max())
    err64 = float((got.double() - ref).abs().max())
    plain64 = float((want.double() - ref).abs().max())
    aug = aug.reshape(-1, aug.shape[-1])
    rec = {"phase": "kernel", "kernel": "fused_loglike", "case": "siren",
           "B": b, "T": t, "D": d, "C": c, "rows": b * t,
           "max_abs_err": err, "max_abs_loglike": float(want.abs().max()),
           "tolerance": 2e-6 * float(want.abs().max()),
           "max_abs_err_f64": err64, "plain_max_abs_err_f64": plain64,
           "tolerance_f64": "2 x the plain f32 product's",
           "ms": cuda_ms(lambda: L.fused_loglike(x, p.quad_proj, p.gconsts),
                         3, 20),
           "plain_ms": cuda_ms(
               lambda: L.fused_loglike_plain(x, p.quad_proj, p.gconsts),
               1, 3),
           "library_ms": cuda_ms(
               lambda: torch.addmm(p.gconsts, aug, p.quad_proj), 3, 20),
           "library_call": "torch.addmm(gconsts, aug, quad_proj) on a "
                           "pre-built f32 aug"}
    rec["ok"] = err <= rec["tolerance"] and err64 <= 2.0 * plain64
    rec["bound_ms"], rec["bound_by"] = gmm_bounds(b, t, d, c)[
        "fused_loglike"]
    emit(rec)
    if not rec["ok"]:
        raise RuntimeError(f"fused_loglike at the Siren guard shape: {rec}")
    out["fused_loglike"] = rec
    return out


# A deterministic stand-in for ffmpeg, the script of
# tests/test_speech_compression.py: it quantises to 512-step levels, and on
# decode prepends and appends junk samples per codec, so the realignment
# (start hints, the min-L1 search) has work
STAND_IN_FFMPEG = r'''#!{python}
"""Deterministic stand-in for ffmpeg: quantizes to 512-step levels, and on
decode prepends/appends junk samples per "codec" so the caller's
realignment logic has real work to do."""
import sys
import numpy as np
from scipy.io import wavfile

args = sys.argv[1:]
src = args[args.index("-i") + 1]
dst = args[-1]
decode = "pcm_s16le" in args

rate, data = wavfile.read(src)
data = data.astype(np.int64)
if decode:
    ext = src.rsplit(".", 1)[-1]
    pre = {{"opus": 69, "spx": 37, "mp3": 0, "aac": 11, "amr": 5}}[ext]
    junk_l = np.full(pre, 30000, np.int64)
    junk_r = np.full(13, -30000, np.int64)
    data = np.concatenate([junk_l, data, junk_r])
else:
    data = (data // 512) * 512
wavfile.write(dst, rate, np.clip(data, -32768, 32767).astype(np.int16))
'''

# each real codec's encoder, as ffmpeg -encoders lists it (the JAX
# package's tests/test_speech_compression.py _REAL_CODECS)
REAL_CODECS = [("OPUS", 16000, "libopus"), ("SPEEX", 16000, "libspeex"),
               ("AMR", 6600, "libvo_amrwbenc"), ("AAC_V", 3, "libfdk_aac"),
               ("AAC_C", 16000, "libfdk_aac"), ("MP3_V", 5, "mp3"),
               ("MP3_C", 16000, "mp3")]


def adpcm_bound_ms(b, length, bits, clock_mhz):
    """(bytes ms, operations ms, serial-chain ms) of the ADPCM round-trip.
    Bytes: each sample read once and written once, f32.  Operations: 6 +
    5 (bits - 1) f32 operations a sample (the difference, its sign and
    magnitude, the clamps and adds of the update; a compare, a select and
    three adds per tap) at the f32 rate.  The chain: sample t needs the
    predictor that sample t - 1 left, so a wave is L dependent steps, and
    within a step the predictor's own dependent chain is irreducible
    whatever the coder's form or the table's place: the difference x -
    pred, the coder's decision (one stage of compares, all thresholds at
    once), the reconstruction (one select), the add to the predictor and
    the two-sided clamp (two operations): 6 dependent operations, at 4
    cycles each (the shortest latency of a dependent f32 operation on
    Hopper), 24 cycles a sample at the card's highest SM clock.  The step
    index's own chain runs beside it.  A latency model, not a
    measurement."""
    byte_ms = b * length * 4 * 2 / HBM_BYTES_PER_S * 1e3
    op_ms = b * length * (6 + 5 * (bits - 1)) / F32_FLOPS * 1e3
    cycles = ADPCM_CHAIN_OPS * 4
    return byte_ms, op_ms, length * cycles / (clock_mhz * 1e6) * 1e3


ADPCM_CHAIN_OPS = 6   # adpcm_bound_ms: the predictor's dependent operations


def adpcm_edge_waves(bits, length=600, seed=12):
    """(6, length) int16-domain waves that reach the ADPCM recurrence's
    edges: 0 a full-scale square then silence (the step index falls to 0
    and stays); 1 a full-scale square (the index rises to 88, remainders of
    two steps and more); 2 32767 then -32768 (the predictor held at both
    clamps); 3 each sample exactly on a coder threshold, pred +- k*u with u
    = step / 2^(bits - 2), the state followed through the JAX body in
    numpy float32; 4 jumps of +-20000; 5 uniform noise."""
    from speakerguard_tpu_torch.ops.adpcm import IMA_INDEX_ADJ, IMA_STEPS
    f32 = np.float32
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    square = np.where(t % 2 == 0, 32767.0, -32767.0)
    x = np.zeros((6, length), f32)
    x[0, :100] = square[:100]
    x[1] = square
    x[2, : length // 2], x[2, length // 2:] = 32767.0, -32768.0
    x[4] = np.where(rng.random(length) < 0.5, 20000.0, -20000.0)
    x[5] = rng.uniform(-30000, 30000, length)
    n, k_max = bits - 1, 2 ** (bits - 1) - 1
    pred, idx = f32(0), 0
    for i in range(length):
        step = IMA_STEPS[idx]
        k = f32(rng.integers(1, k_max + 1))
        u = step * f32(2.0 ** -(n - 1))
        while k > 1 and abs(pred) + k * u > 32767:
            k = f32(k // 2)
        x[3, i] = pred - k * u if pred > 0 else pred + k * u
        diff = f32(x[3, i] - pred)
        rem, code, recon, s = abs(diff), 0, f32(0), step
        for _ in range(n):
            bit = rem >= s
            code = 2 * code + int(bit)
            rem = f32(rem - s) if bit else rem
            recon = f32(recon + (s if bit else f32(0)))
            s = f32(s * f32(0.5))
        recon = f32(recon + s)
        pred = f32(min(max(f32(pred + (-recon if diff < 0 else recon)),
                           -32768.0), 32767.0))
        idx = int(min(max(idx + IMA_INDEX_ADJ[min(code, 7)], 0), 88))
    return x


def phase_codec_small_reference(torch, clock_mhz):
    """The speech codecs on the card.
      MULAW   512 x 3 s on the card against the CPU: within rtol 1e-6 and
              atol 1e-6 x max |out| (log1p and pow differ by an ulp between
              the two libraries, and 256 ** |q| - 1 cancels for the levels
              next to 0); a quantised level may flip only at a near tie,
              where the companded value lies within 1e-4 of a half level
              (counted).
      ADPCM   the kernel torch.equal to adpcm_plain on the card at
              512 x 4,800 samples, and to the CPU plain loop on waves 0-7
              and 504-511 of the full 3 s batch, for every bits 2..16 at
              64 x 2,000 and on adpcm_edge_waves; the fused defense
              (SC.ADPCM: one aminmax, one launch) torch.equal to the
              unfused composition (_to_scale, the clamp, the int16 kernel,
              the scaling back) in both domains; the kernel's ms at
              512 x 4,800 and 512 x 48,000, its cycles a sample, the plain
              version's on the card at both, the defense's ms fused and
              unfused, the bounds of adpcm_bound_ms.
      host    OPUS (start hint) and SPEEX (min-L1 search) at 8 x 3 s
              through the stand-in ffmpeg, first on PATH for this phase
              only: the output equal to the stand-in's quantisation, the
              BPDA input gradient equal to the incoming gradient, ms a
              call.  Where the machine has an ffmpeg of its own, each real
              codec whose encoder ``ffmpeg -encoders`` lists also runs on
              a speech-like 3 s wave (shape kept, finite).
    Returns the ADPCM record."""
    import shutil
    import tempfile
    from speakerguard_tpu_torch.defenses import speech_compression as SC
    from speakerguard_tpu_torch.ops import adpcm as A
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.uniform(-0.6, 0.6, (512, 48000)).astype(np.float32))
    xc = x.to("cuda")

    # MULAW
    got = SC.MULAW(xc, 255).cpu()
    want = SC.MULAW(x, 255)
    scale = float(want.abs().max())
    close = torch.isclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    mu = 255.0
    x64 = x.double().clamp(-1, 1)
    level = ((torch.sign(x64) * torch.log1p(mu * x64.abs()) / np.log1p(mu)
              + 1.0) * 0.5 * mu)
    near_tie = (level - torch.floor(level) - 0.5).abs() < 1e-4
    flips = ~close
    mulaw = {"codec": "MULAW", "shape": list(x.shape),
             "max_abs_err": float((got - want).abs().max()),
             "bar": "rtol 1e-6, atol 1e-6 x max|out|; a level may flip "
                    "only at a near tie",
             "samples_outside_bar": int(flips.sum()),
             "outside_bar_at_near_ties": int((flips & near_tie).sum()),
             "ms": cuda_ms(lambda: SC.MULAW(xc, 255), 2, 10)}
    mulaw["ok"] = bool(not (flips & ~near_tie).any())
    del got, want, x64, level, near_tie, flips, close

    # ADPCM: the kernel against the plain loop
    x16 = torch.clamp(xc * 32768.0, -32768.0, 32767.0)
    short = x16[:, :4800].contiguous()
    k_short = A.adpcm(short, 4)
    torch.cuda.synchronize()
    p_short = A.adpcm_plain(short, 4)
    k_full = A.adpcm(x16, 4)
    rows = list(range(8)) + list(range(504, 512))
    cpu_full = A.adpcm_plain(x16[rows].cpu(), 4)
    torch.cuda.synchronize()
    err = max(float((k_short - p_short).abs().max()),
              float((k_full[rows].cpu() - cpu_full).abs().max()))
    # every bits, at 64 x 2,000 and on the edge inputs, against the CPU loop
    unequal_bits = []
    for bits in range(2, 17):
        for case in (x16[:64, :2000], torch.tensor(adpcm_edge_waves(bits),
                                                   device="cuda")):
            got = A.adpcm(case.contiguous(), bits).cpu()
            want = A.adpcm_plain(case.cpu(), bits)
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                unequal_bits.append(bits)
    # the fused defense against the unfused composition, both domains
    def unfused_defense(wav):
        scaled, restore = SC._to_scale(wav)
        return A.adpcm(torch.clamp(scaled * 32768.0, -32768.0, 32767.0),
                       4) / 32768.0 * restore

    fused_equal = {domain: bool(torch.equal(SC.ADPCM(wav, 4),
                                            unfused_defense(wav)))
                   for domain, wav in (("scale", xc), ("origin", xc * 32768.0))}

    byte_ms, op_ms, chain_ms = adpcm_bound_ms(512, 48000, 4, clock_mhz)
    t0 = time.perf_counter()
    A.adpcm_plain(x16, 4)
    torch.cuda.synchronize()
    plain_full_ms = (time.perf_counter() - t0) * 1e3
    adpcm = {"codec": "ADPCM", "bits": 4, "shape": list(x.shape),
             "equal_to_plain_card_512x4800": bool(torch.equal(k_short,
                                                              p_short)),
             "equal_to_plain_cpu_waves_0_7_504_511": bool(torch.equal(
                 k_full[rows].cpu(), cpu_full)),
             "unequal_bits_64x2000_or_edges": sorted(set(unequal_bits)),
             "fused_defense_equal_to_unfused": fused_equal,
             "max_abs_err": err,
             "ms": cuda_ms(lambda: A.adpcm(x16, 4), 2, 10),
             "ms_512x4800": cuda_ms(lambda: A.adpcm(short, 4), 2, 10),
             "plain_ms": plain_full_ms,
             "plain_ms_512x4800": cuda_ms(lambda: A.adpcm_plain(short, 4),
                                          0, 1),
             "defense_ms": cuda_ms(lambda: SC.ADPCM(xc, 4), 2, 10),
             "defense_unfused_ms": cuda_ms(lambda: unfused_defense(xc), 2,
                                           10),
             "bound_bytes_ms": byte_ms, "bound_ops_ms": op_ms,
             "bound_chain_ms": chain_ms, "chain_ops": ADPCM_CHAIN_OPS,
             "sm_clock_max_mhz": clock_mhz,
             "binds": ("serial chain" if chain_ms > max(byte_ms, op_ms)
                       else "bytes" if byte_ms >= op_ms else "operations")}
    adpcm["cycles_per_sample"] = (adpcm["ms"] * 1e-3 * clock_mhz * 1e6
                                  / 48000)
    adpcm["ok"] = (adpcm["equal_to_plain_card_512x4800"]
                   and adpcm["equal_to_plain_cpu_waves_0_7_504_511"]
                   and not unequal_bits and all(fused_equal.values()))
    del x16, short, k_short, p_short, k_full, cpu_full

    # the host codecs through the stand-in ffmpeg
    real = shutil.which("ffmpeg")
    tmp = tempfile.mkdtemp(prefix="stand-in-ffmpeg-")
    path = os.environ.get("PATH", "")
    host = []
    try:
        script = os.path.join(tmp, "ffmpeg")
        with open(script, "w") as f:
            f.write(STAND_IN_FFMPEG.format(python=sys.executable))
        os.chmod(script, 0o755)
        os.environ["PATH"] = tmp + os.pathsep + path
        xs = xc[:8]
        x16 = np.clip(xs.cpu().numpy() * 32768.0, -32768, 32767).astype(
            np.int16)
        expected = torch.tensor(((x16.astype(np.int64) // 512) * 512)
                                .astype(np.float32) / 32768.0)
        g = torch.randn(xs.shape, generator=torch.Generator(
            device="cuda").manual_seed(5), device="cuda")
        for name, param in (("OPUS", 16000), ("SPEEX", 43200)):
            fn = getattr(SC, name)
            xx = xs.clone().requires_grad_(True)
            t0 = time.perf_counter()
            y = fn(xx, param)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
            (y * g).sum().backward()
            rec = {"codec": name, "param": param, "shape": list(y.shape),
                   "ffmpeg": "stand-in",
                   "equal_to_expected": bool(torch.equal(y.detach().cpu(),
                                                         expected)),
                   "gradient_equal_to_incoming": bool(torch.equal(xx.grad,
                                                                  g)),
                   "device": str(y.device), "ms": call_ms}
            rec["ok"] = (rec["equal_to_expected"]
                         and rec["gradient_equal_to_incoming"]
                         and y.device.type == "cuda")
            host.append(rec)
    finally:
        os.environ["PATH"] = path
        shutil.rmtree(tmp, ignore_errors=True)

    real_rec = {"ffmpeg": real}
    if real:
        encoders = subprocess.run([real, "-hide_banner", "-encoders"],
                                  capture_output=True, text=True).stdout
        t = np.arange(48000) / 16000.0
        speech = torch.tensor((0.4 * np.sin(2 * np.pi * 220 * t)
                               * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)))
                              .astype(np.float32)[None], device="cuda")
        ran, skipped = [], []
        for name, param, encoder in REAL_CODECS:
            if encoder not in encoders:
                skipped.append(name)
                continue
            try:
                y = getattr(SC, name)(speech, param)
            except Exception as exc:  # noqa: BLE001 - the encoder refused
                skipped.append(f"{name}: {str(exc)[:80]}")
                continue
            if y.shape != speech.shape or not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"real ffmpeg {name}: {tuple(y.shape)}")
            ran.append(name)
        real_rec.update(ran=ran, skipped=skipped)
    emit({"phase": "codec_small_reference", "mulaw": mulaw, "adpcm": adpcm,
          "host": host, "real_ffmpeg": real_rec})
    bad = [r["codec"] for r in [mulaw, adpcm, *host] if not r["ok"]]
    if bad:
        raise RuntimeError(f"codec checks failed: {bad}")
    return adpcm


def run_kenan_slice(torch, name, model, x, wrappers, expected_fn, fields,
                    atk_kw, warmup=True):
    """make_decision (its decisions are the labels), then Kenan(``atk_kw``),
    after a warm-up of one step unless ``warmup`` is False.  The counts are
    set to 0 just before make_decision and read just after the attack;
    ``expected_fn(atk)`` gives the expected counts, and every plain count
    must stay 0.  Hard checks: finite audio, the score shape, and the
    success vector equal to an exact re-decision of the returned audio
    (the model has no dither).  Returns (launch counts, record)."""
    from speakerguard_tpu_torch.attacks import Kenan
    batch = x.shape[0]
    t0 = time.perf_counter()
    if warmup:
        Kenan(model, **{**atk_kw, "max_iter": 1}).attack(
            x, torch.zeros(batch, dtype=torch.long, device="cuda"), rng=1)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        decisions, scores = model.make_decision(x)
    labels = decisions.long()
    atk = Kenan(model, **atk_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adver, success = atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    attack_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        redecided = (model.make_decision(adver)[0] != labels).tolist()
    expected = {k: 0 for k in wrappers}
    expected.update(expected_fn(atk))
    finite = bool(torch.isfinite(scores).all() and torch.isfinite(adver).all())
    rec = {"phase": name, **fields, "task": "CSI-E",
           "speakers": model.num_spks, "batch": batch,
           "samples": int(x.shape[1]), "attack": "Kenan", **atk_kw,
           "warmup_1_step_s": warmup_s if warmup else None,
           "attack_s": attack_s, "executed_steps": atk.last_executed_steps,
           "ms_per_step": attack_s * 1e3 / atk.last_executed_steps,
           "utts_per_s": batch / attack_s,
           "asr_pct": 100.0 * sum(success) / batch, "peak_mem_gib": peak,
           "scores_shape": list(scores.shape), "finite": finite,
           "matches_exact_redecision": redecided == success,
           "success": [int(v) for v in success],
           "redecided": [int(v) for v in redecided],
           "launches": launches, "launches_expected": expected,
           "plain_calls": plain}
    if not (finite and rec["matches_exact_redecision"]
            and list(scores.shape) == [batch, model.num_spks]):
        emit(rec)
        raise RuntimeError(f"{name} output check failed")
    wrong = {k: v for k, v in expected.items() if launches[k] != v}
    if wrong or any(plain.values()):
        emit(rec)
        raise RuntimeError(f"{name}: launches {launches} (expected "
                           f"{expected}), plain calls {plain}")
    return launches, rec


def ssa_checks(torch, wav_i, window, driver):
    """The device SSA of ``wav_i`` (B, N) int16-valued waves: the SVD's ms
    per wave (one call for the batch), the full reconstruction (keep =
    window) against the input at 1e-4 of max |x|, and the top 100 squared
    singular values of each wave against the float64 eigenvalues of its
    window x window Gram matrix at rtol 1e-3."""
    from speakerguard_tpu_torch.ops import ssa as ssa_mod
    b, _ = wav_i.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc, s, v = ssa_mod.ssa_device(wav_i, window, driver)
    torch.cuda.synchronize()
    svd_ms = (time.perf_counter() - t0) * 1e3 / b
    rec_full = ssa_mod.inv_ssa_masked(pc, v, torch.full(
        (b,), window, device="cuda"))
    full_err = float(((rec_full - wav_i).abs().amax(dim=1)
                      / wav_i.abs().amax(dim=1)).max())
    del pc, v, rec_full
    eig_err = 0.0
    for i in range(b):
        traj = ssa_mod.trajectory(wav_i[i:i + 1].double(), window)[0]
        eig = torch.linalg.eigvalsh(traj @ traj.mT).flip(0)[:100]
        s2 = s[i, :100].double() ** 2
        eig_err = max(eig_err, float(((s2 - eig).abs() / eig).max()))
        del traj
    rec = {"driver": driver or "default", "svd_ms_per_wave": svd_ms,
           "full_reconstruction_err_over_max": full_err,
           "full_reconstruction_bar": 1e-4,
           "top100_sv2_vs_f64_eig_max_rel_err": eig_err,
           "sv2_bar_rel": 1e-3}
    rec["ok"] = full_err <= 1e-4 and eig_err <= 1e-3
    return rec


def run_siren_slice(torch, name, model, x, wrappers, expected_fn, fields,
                    atk_kw):
    """make_decision (its decisions are the labels), then
    SirenAttack(``atk_kw``) after a warm-up of one epoch of one iteration.
    The counts are set to 0 just before make_decision and read just after
    the attack; ``expected_fn(atk)`` gives the expected counts from the
    particle evaluations and guard forwards the attack reports, and every
    plain count must stay 0.  Hard checks: finite audio within eps, the
    score shape, and the success vector equal to the margin loss (< 0) of
    an exact re-evaluation of the returned audio, with the dither draw of
    the attack's own re-evaluation replayed.  Returns (launch counts,
    record)."""
    from speakerguard_tpu_torch.attacks import SirenAttack
    from speakerguard_tpu_torch.attacks.losses import margin_loss
    batch = x.shape[0]
    t0 = time.perf_counter()
    SirenAttack(model, **{**atk_kw, "max_epoch": 1, "max_iter": 1}).attack(
        x, torch.zeros(batch, dtype=torch.long, device="cuda"), rng=1)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        decisions, scores = model.make_decision(x)
    labels = decisions.long()
    atk = SirenAttack(model, **atk_kw)
    states = recording_exact_scores(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adver, success = atk.attack(x, labels, rng=0)
    torch.cuda.synchronize()
    attack_s = time.perf_counter() - t0
    del model.score
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        gen = None
        if states:
            gen = torch.Generator(device="cuda")
            gen.set_state(states[-1])
        loss = margin_loss(model.score(adver, rng=gen), labels, task="CSI",
                           clip_max=False)
    expected = {k: 0 for k in wrappers}
    expected.update(expected_fn(atk))
    evals = atk.last_particle_evals
    finite = bool(torch.isfinite(scores).all() and torch.isfinite(adver).all())
    within = float((adver - x).abs().max()) <= atk.epsilon + 1e-6
    fp = model.fast_path
    rec = {"phase": name, **fields, "task": "CSI-E",
           "speakers": model.num_spks, "batch": batch,
           "samples": int(x.shape[1]), "attack": "SirenAttack", **atk_kw,
           "fast_path": None if fp is None else vars(fp),
           "waves_per_evaluation": batch * atk.n_particles,
           "warmup_1_iter_s": warmup_s, "attack_s": attack_s,
           "executed_epochs": atk.last_executed_epochs,
           "particle_evals": evals, "guard_evals": atk.last_guard_evals,
           "ms_per_particle_eval": attack_s * 1e3 / max(evals, 1),
           "utts_per_s": batch / attack_s,
           "asr_pct": 100.0 * sum(success) / batch, "peak_mem_gib": peak,
           "scores_shape": list(scores.shape), "finite": finite,
           "within_eps": within,
           "matches_exact_reevaluation": (loss < 0).tolist() == success,
           "reevaluation_dither_replayed": bool(states),
           "success": [int(v) for v in success],
           "launches": launches, "launches_expected": expected,
           "plain_calls": plain}
    if not (finite and within and rec["matches_exact_reevaluation"]
            and list(scores.shape) == [batch, model.num_spks]):
        emit(rec)
        raise RuntimeError(f"{name} output check failed")
    wrong = {k: v for k, v in expected.items() if launches[k] != v}
    if wrong or any(plain.values()):
        emit(rec)
        raise RuntimeError(f"{name}: launches {launches} (expected "
                           f"{expected}), plain calls {plain}")
    return launches, rec


def phase_slice15(torch, wrappers):
    """The attacks and the codec of this slice at full width, weights from
    numpy seed 0, 10 speakers enrolled from waves, task CSI-E, 3 s waves,
    the clean decisions as labels.
      slice_defended_adpcm_xv  xv-PLDA, FastPath(), ADPCM 4 @0 (BPDA,
                               straight-through), PGD-10 with EOT 1 at
                               batch 512: adpcm once per forward (12: the
                               iterations, make_decision, the final
                               evaluation), every other count 0.
      slice_kenan_ssa_xv       xv-PLDA, FastPath(), dither 0, Kenan ssa 15
                               steps at batch 4 (window 2400; the SVD's
                               driver ops/ssa.py's SVD_DRIVER): every count
                               0; the SVD's checks and ms (ssa_checks).
      slice_siren_xv           xv-PLDA, FastPath(), batch 32, 25 particles,
                               2 epochs x 30 iterations, abort off (800
                               waves an evaluation): every count 0.
      slice_kenan_fft_iv       iv-PLDA, FastPath(enabled=False),
                               loglike_kernel=True, dither 0, Kenan fft 15
                               steps at batch 64: fused_loglike and
                               cholesky_rt once per decision (16).
      slice_siren_iv           iv-PLDA, FastPath(gmm_topk=0,
                               stats_kernel=True), loglike_kernel=True, the
                               default dither, SirenAttack(fast=True), batch
                               16, 25 particles, 2 epochs x 30 iterations,
                               abort off: stats_fwd once per particle
                               evaluation (at 120,000 rows), fused_loglike
                               once per guard forward + 2, cholesky_rt
                               their sum, stats_bwd 0.
    Returns {slice: launch counts}."""
    import dataclasses
    from speakerguard_tpu_torch.defenses.registry import parser_defense
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.models.defended import DefendedModel
    from speakerguard_tpu_torch.models.iv_plda import (IvPlda,
                                                       random_iv_plda_params)
    from speakerguard_tpu_torch.models.tdnn import TDNN_SPEC
    from speakerguard_tpu_torch.models.xv_plda import (XvPlda,
                                                       random_xv_plda_params)
    from speakerguard_tpu_torch.ops.kaldi_mfcc import (IV_PLDA_MFCC,
                                                       XV_PLDA_MFCC)
    from speakerguard_tpu_torch.ops.ssa import SVD_DRIVER
    n_spk, length = 10, 48000
    spk = [f"spk{i}" for i in range(n_spk)]
    out = {}

    # xv-PLDA: ADPCM before the model, Kenan ssa, Siren
    t0 = time.perf_counter()
    xparams = random_xv_plda_params(np.random.default_rng(0), device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    with torch.no_grad():
        enroll = XvPlda(xparams, fast=FastPath(enabled=False)).embedding(
            torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (512, length)).astype(
        np.float32), device="cuda")
    base = XvPlda(xparams, fast=FastPath())
    base.set_enrollment(spk, enroll)
    torch.cuda.synchronize()
    emit({"phase": "setup_slice15_xv", "seconds": time.perf_counter() - t0})
    xfields = {"model": "xv_plda", "tdnn_spec": TDNN_SPEC, "num_ceps": 30,
               "emb_dim": 512, "R": 150}
    defense, canonical = parser_defense(["ADPCM"], ["4"], [0], "sequential")
    model = DefendedModel(base, defense, "sequential")
    iters = 10
    expected = {k: 0 for k in wrappers}
    expected["adpcm"] = iters + 2
    out["slice_defended_adpcm_xv"] = run_defended_slice(
        torch, "slice_defended_adpcm_xv", model, x, wrappers, expected,
        {**xfields, "defense": canonical}, None, iters, 1)
    del model
    torch.cuda.empty_cache()

    # the decisions of Kenan and of the re-decision without dither; the xv
    # weights are warm: no warm-up attack (it would pay the SVDs again)
    model = XvPlda(xparams, fast=FastPath(), mfcc_config=dataclasses.replace(
        XV_PLDA_MFCC, dither=0.0))
    model.set_enrollment(spk, enroll)
    out["slice_kenan_ssa_xv"], rec = run_kenan_slice(
        torch, "slice_kenan_ssa_xv", model, x[:4], wrappers, lambda a: {},
        {**xfields, "window": 2400, "dither": 0.0, "svd_driver": SVD_DRIVER},
        dict(atk_name="ssa", max_iter=15), warmup=False)
    wav_i = torch.trunc(x[:4] * 32768.0)  # the attack's int16 truncation
    rec["ssa"] = ssa_checks(torch, wav_i, 2400, SVD_DRIVER)
    emit(rec)
    if not rec["ssa"]["ok"]:
        raise RuntimeError(f"slice_kenan_ssa_xv SSA checks: {rec['ssa']}")
    del wav_i, model
    torch.cuda.empty_cache()

    siren = dict(epsilon=0.002, max_epoch=2, max_iter=30, n_particles=25,
                 abort_early=False, fast=True)
    out["slice_siren_xv"], rec = run_siren_slice(
        torch, "slice_siren_xv", base, x[:32], wrappers, lambda a: {},
        xfields, siren)
    emit(rec)
    del base, xparams, enroll, x
    torch.cuda.empty_cache()

    # iv-PLDA: Kenan fft on the exact path, Siren on the GMM kernels
    t0 = time.perf_counter()
    params = random_iv_plda_params(np.random.default_rng(0), 2048, 72, 600,
                                   200, device="cuda")
    rng = np.random.default_rng(1)
    enroll_wavs = rng.uniform(-0.3, 0.3, (n_spk, length)).astype(np.float32)
    no_dither = dataclasses.replace(IV_PLDA_MFCC, dither=0.0)
    with torch.no_grad():
        enroll = IvPlda(params, fast=FastPath(enabled=False),
                        mfcc_config=no_dither).embedding(
            torch.tensor(enroll_wavs, device="cuda"))
    x = torch.tensor(rng.uniform(-0.3, 0.3, (64, length)).astype(
        np.float32), device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "setup_slice15_iv", "seconds": time.perf_counter() - t0})
    ifields = {"model": "iv_plda", "C": 2048, "D": 72, "IV": 600, "R": 200,
               "loglike_kernel": True}
    model = IvPlda(params, fast=FastPath(enabled=False), loglike_kernel=True,
                   mfcc_config=no_dither)
    model.set_enrollment(spk, enroll)
    decisions = 1 + 15
    out["slice_kenan_fft_iv"], rec = run_kenan_slice(
        torch, "slice_kenan_fft_iv", model, x, wrappers,
        lambda a: {"fused_loglike": decisions, "cholesky_rt": decisions},
        {**ifields, "dither": 0.0}, dict(atk_name="fft", max_iter=15))
    emit(rec)

    model = IvPlda(params, fast=FastPath(gmm_topk=0, stats_kernel=True),
                   loglike_kernel=True)
    model.set_enrollment(spk, enroll)

    def siren_counts(a):
        exact = a.last_guard_evals + 2  # make_decision, the re-evaluation
        return {"stats_fwd": a.last_particle_evals, "fused_loglike": exact,
                "cholesky_rt": a.last_particle_evals + exact}

    out["slice_siren_iv"], rec = run_siren_slice(
        torch, "slice_siren_iv", model, x[:16], wrappers, siren_counts,
        {**ifields, "dither": IV_PLDA_MFCC.dither}, siren)
    emit(rec)
    return out


TRAIN_BATCH, TRAIN_LEN, TRAIN_CLASSES = 128, 80000, 251


def _tree_close(torch, got, want, bar):
    """{leaf: error} of two trees of tensors (``got`` moved to ``want``'s
    device); ``bar(name, want_leaf, top) -> allowed error``, ``top`` the
    largest |entry| over all of ``want``'s leaves."""
    from speakerguard_tpu_torch.models.base import tree_leaves
    w = dict(tree_leaves(want))
    top = max(float(t.abs().max()) for t in w.values())
    errs, bad = {}, []
    for n, t in tree_leaves(got):
        e = float((t.to(w[n].device).float() - w[n].float()).abs().max())
        errs[n] = e
        if not e <= bar(n, w[n], top):
            bad.append(n)
    return errs, bad


def _pool_orders(torch, an, fn):
    """Run ``fn()`` with AudioNet's max-pools recorded: [(input, the
    index of each window's larger element)] in call order."""
    orig, seen = an._maxpool1d, []

    def recording(x):
        b, c, t = x.shape
        w = x.detach()[:, :, :2 * (t // 2)].reshape(b, c, t // 2, 2)
        seen.append((w, w.argmax(dim=-1)))
        return orig(x)

    an._maxpool1d = recording
    try:
        out = fn()
    finally:
        an._maxpool1d = orig
    return out, seen


def phase_train_small_reference(torch):
    """One f32 natural step of AudioNet (10 classes) at 4 waves of 16,000
    samples on the card and on the CPU from the same weights and the same
    augmentation draws.

    The features of the doubled batch: rtol 1e-4, atol 1e-3 (dB), as the
    CPU tests hold the frontend.  The loss (rtol 1e-5), the new BN state
    (rtol 1e-5, atol 1e-6) and the updated parameters (within 2 lr).  The
    gradient: the max-pools and the max over time send it through one
    element of each window, so where a window's two values lie within
    rounding of each other the devices may pick different elements and
    every leaf ahead of that pool gets another, equally valid, gradient.
    The phase records each pool's inputs on both devices: the leaves after
    the first pool whose order differs (all leaves when none does) are held
    to 1e-4 of their scale (the larger of their largest |g| and 1% of the
    model's: the conv biases ahead of a train-mode BN have an exact
    gradient of 0, conv1's BN scale nearly so), and each window whose order
    differs must be a near tie (its two values within 1e-4 of each other,
    relative).  Then the CNN alone in float64 on both devices, on the same
    features, where rounding cannot reorder such a window: every gradient
    leaf within 1e-9 of its scale.  Last, the checkpoint round trip on the
    card: save, load, and the next step equal to the step without the
    round trip (loss rtol 1e-6), as tests/test_training.py:46 holds it."""
    import tempfile
    from speakerguard_tpu_torch.models import audionet as an
    from speakerguard_tpu_torch.models.base import (tree_leaves, tree_map,
                                                    tree_rebuild)
    from speakerguard_tpu_torch.models.training import (
        cross_entropy, load_checkpoint, loss_and_grads,
        make_natural_train_step, save_checkpoint)
    from speakerguard_tpu_torch.ops.logmel import audionet_logmel
    from speakerguard_tpu_torch.optim import Adam
    rng = np.random.default_rng(21)
    params, state = an.init_audionet(rng, 10, device="cpu")
    wavs = rng.uniform(-0.3, 0.3, (4, 16000)).astype(np.float32)
    labels = rng.integers(0, 10, 4)
    a = np.float32(rng.random())
    noise = rng.random((4, 16000), dtype=np.float32)
    lr = 1e-3
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        s = tree_map(lambda t: t.to(dev), state)
        x = torch.tensor(wavs, device=dev)
        y = torch.tensor(labels, device=dev)
        draws = {"aug_scale": torch.tensor(a, device=dev),
                 "aug_noise": torch.tensor(noise, device=dev)}
        adam = Adam(lr)
        step = make_natural_train_step(adam, aug_eps=0.002)
        res = step(p, s, adam.init(p), x, y,
                   draw_fn=lambda kind, shape: draws[kind])
        x_all = torch.cat([x, x + (2.0 * draws["aug_scale"] * 0.002
                                   * draws["aug_noise"]
                                   - draws["aug_scale"] * 0.002)])
        y_all = torch.cat([y, y])
        with torch.no_grad():
            feats = audionet_logmel(x_all)
        (_, grads, _, _), pools = _pool_orders(
            torch, an, lambda: loss_and_grads(p, s, x_all, y_all))
        out[dev] = (res, grads, feats, pools)
    (c_res, c_g, c_f, c_pools), (g_res, g_g, g_f, g_pools) = (out["cpu"],
                                                              out["cuda"])
    feat_err = float((g_f.cpu() - c_f).abs().max())
    feat_ok = bool(torch.allclose(g_f.cpu(), c_f, rtol=1e-4, atol=1e-3))
    loss_err = abs(float(g_res[3]) - float(c_res[3]))

    # the pools whose window order differs, and the leaves after the first
    flips, near = [], True
    for i, ((cw, ci), (gw, gi)) in enumerate(zip(c_pools, g_pools)):
        differ = (gi.cpu() != ci) & (cw.amax(-1) > 0)
        n = int(differ.sum())
        if n:
            gap = ((cw[..., 0] - cw[..., 1]).abs()
                   / cw.abs().amax(-1).clamp_min(1e-30))[differ]
            flips.append({"pool": i, "windows": n,
                          "max_rel_gap": float(gap.max())})
            near = near and float(gap.max()) <= 1e-4
    pool_blocks = [i for i, spec in enumerate(an.CONV_SPEC) if spec[4]]
    first = pool_blocks[flips[0]["pool"]] if flips else None

    def after_first_flip(n):
        if first is None:
            return True
        if n.startswith(("fc_", "conv1_")):
            return n.startswith("fc_")
        return int(n.rsplit("__", 1)[1]) > first

    def grad_bar(n, w, top):
        if not after_first_flip(n):
            return float("inf")
        return 1e-4 * max(float(w.abs().max()), 1e-2 * top)

    grad_errs, grad_bad = _tree_close(torch, g_g, c_g, grad_bar)
    state_errs, state_bad = _tree_close(
        torch, g_res[1], c_res[1],
        lambda n, w, top: 1e-6 + 1e-5 * float(w.abs().max()))
    param_errs, param_bad = _tree_close(torch, g_res[0], c_res[0],
                                        lambda n, w, top: 2 * lr)

    # the CNN alone in float64 on the same features
    g64, pools64 = {}, {}
    y_all = torch.tensor(np.concatenate([labels, labels]))
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, torch.float64), params)
        s = tree_map(lambda t: t.to(dev, torch.float64), state)
        leaves = dict(tree_leaves(tree_map(
            lambda t: t.requires_grad_(True), p)))

        def grads64():
            logits, _, _ = an.audionet_logits(
                tree_rebuild(p, leaves.__getitem__), s,
                c_f.to(dev, torch.float64), train=True)
            return torch.autograd.grad(torch.mean(cross_entropy(
                logits, y_all.to(dev))), list(leaves.values()))

        g, pools64[dev] = _pool_orders(torch, an, grads64)
        g64[dev] = dict(zip(leaves, g))
    top64 = max(float(t.abs().max()) for t in g64["cpu"].values())
    f64_errs = {n: float((g64["cuda"][n].cpu() - t).abs().max()
                         / max(float(t.abs().max()), 1e-2 * top64))
                for n, t in g64["cpu"].items()}
    f64_flips = [int(((gi.cpu() != ci) & (cw.amax(-1) > 0)).sum())
                 for (cw, ci), (_, gi) in zip(pools64["cpu"],
                                              pools64["cuda"])]

    # the checkpoint round trip on the card
    p, s, o = g_res[:3]
    x = torch.tensor(wavs, device="cuda")
    y = torch.tensor(labels, device="cuda")
    step = make_natural_train_step(lr, aug_eps=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "audionet.ckpt")
        save_checkpoint(path, p, s, o, epoch=1)
        p2, s2, o2, epoch = load_checkpoint(path, device="cuda")
    direct = float(step(p, s, o, x, y)[3])
    resumed = float(step(p2, s2, o2, x, y)[3])
    ok = bool(feat_ok and loss_err <= 1e-5 * abs(float(c_res[3]))
              and not grad_bad and near and not state_bad and not param_bad
              and max(f64_errs.values()) <= 1e-9 and epoch == 1
              and o2.count == o.count
              and abs(resumed - direct) <= 1e-6 * abs(direct))
    rec = {"phase": "train_small_reference", "classes": 10, "batch": 4,
           "samples": 16000, "aug_eps": 0.002,
           "feat_max_abs_err": feat_err,
           "loss_cpu": float(c_res[3]), "loss_cuda": float(g_res[3]),
           "loss_abs_err": loss_err,
           "pool_order_differs": flips,
           "grad_leaves_compared": sorted(n for n in grad_errs
                                          if after_first_flip(n)),
           "grad_max_err": max(grad_errs.values()), "grad_errs": grad_errs,
           "grad_bad": grad_bad,
           "f64_grad_max_rel_err": max(f64_errs.values()),
           "f64_grad_rel_errs": f64_errs, "f64_pool_order_differs": f64_flips,
           "state_max_err": max(state_errs.values()),
           "state_bad": state_bad,
           "param_max_err": max(param_errs.values()),
           "param_bad": param_bad,
           "ckpt_loss_direct": direct, "ckpt_loss_resumed": resumed,
           "tolerance": "features rtol 1e-4 atol 1e-3; loss rtol 1e-5; "
                        "gradient leaves after the first pool whose order "
                        "differs (all when none) 1e-4 of max(their max |g|,"
                        " 1% of the model's), differing windows near ties "
                        "(1e-4); float64 CNN gradients 1e-9 of scale; state"
                        " rtol 1e-5 atol 1e-6; parameters 2 lr; resumed "
                        "loss rtol 1e-6",
           "ok": ok}
    emit(rec)
    if not ok:
        raise RuntimeError(f"train_small_reference failed: {rec}")


def _f32_finite(torch, *trees):
    from speakerguard_tpu_torch.models.base import tree_leaves
    return all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for tree in trees for _, t in tree_leaves(tree))


def train_breakdown(torch, params, state, opt_state, wavs, labels, opt):
    """CUDA-event ms of the pieces of one f32 natural step on its doubled
    batch: the exact log-mel frontend; the CNN forward in train mode (the
    BN running-stat updates included); forward and backward to the
    parameter gradient; the Adam update."""
    from speakerguard_tpu_torch.models.audionet import audionet_logits
    from speakerguard_tpu_torch.models.base import tree_leaves, tree_map
    from speakerguard_tpu_torch.models.training import cross_entropy
    from speakerguard_tpu_torch.ops.logmel import audionet_logmel
    x = torch.cat([wavs, wavs])
    y = torch.cat([labels, labels])
    with torch.no_grad():
        feats = audionet_logmel(x)

    def frontend():
        with torch.no_grad():
            audionet_logmel(x)

    def forward():
        with torch.no_grad():
            audionet_logits(params, state, feats, train=True)

    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    flat = [t for _, t in tree_leaves(leaves)]

    def forward_backward():
        logits, _, _ = audionet_logits(leaves, state, feats, train=True)
        torch.autograd.grad(torch.mean(cross_entropy(logits, y)), flat)

    grads = tree_map(torch.ones_like, params)
    return {"frontend_ms": cuda_ms(frontend, 2, 5),
            "cnn_forward_ms": cuda_ms(forward, 2, 5),
            "cnn_forward_backward_ms": cuda_ms(forward_backward, 2, 5),
            "adam_ms": cuda_ms(lambda: opt.update(params, grads, opt_state),
                               2, 5)}


def run_train_slice(torch, name, wrappers, kind, precision, timed,
                    profile_dir, breakdown=False):
    """AudioNet training at the JAX bench's point (bench.py:63-132):
    init_audionet(rng seed 0, 251), then 128 waves of 80,000 samples and
    their labels from the same rng, Adam 1e-3; ``kind`` "natural" (aug_eps
    0.002: 256 waves a step) or "adver" (PGD-10, eps 0.002, step 0.0004, on
    half the batch against the live model; aug_eps 0).  Two warm-up steps
    (cuDNN's autotuning: the first step's shapes, then the second's
    parameters, views into Adam's flat buffer, at new alignments), then
    ``timed`` steps on the one batch, the wrappers' counts set to 0
    just before and read just after (all 0: no hand kernel lies on the
    path).  Asserts that the loss falls and that the parameters, Adam's
    state and the BN state are float32 and finite; for "adver", that the
    adversarial half lies within eps of the clean waves and in [-1, 1].
    Then one profiled step.  Returns the launch counts."""
    from speakerguard_tpu_torch.models.audionet import init_audionet
    from speakerguard_tpu_torch.models.training import (
        make_adver_train_step, make_natural_train_step,
        make_pgd_for_training)
    from speakerguard_tpu_torch.optim import Adam
    rng = np.random.default_rng(0)
    params, state = init_audionet(rng, TRAIN_CLASSES, device="cuda")
    wavs = torch.tensor(rng.uniform(-0.3, 0.3, (TRAIN_BATCH, TRAIN_LEN))
                        .astype(np.float32), device="cuda")
    labels = torch.tensor(rng.integers(0, TRAIN_CLASSES, TRAIN_BATCH),
                          device="cuda")
    opt = Adam(1e-3)
    opt_state = opt.init(params)
    advs = []
    eps = 0.002
    if kind == "adver":
        pgd = make_pgd_for_training(epsilon=eps, step_size=0.0004,
                                    max_iter=10)

        def attack(*a):
            advs.append(pgd(*a))
            return advs[-1]

        step = make_adver_train_step(opt, attack, ratio=0.5, aug_eps=0.0,
                                     compute_dtype=precision)
    else:
        step = make_natural_train_step(opt, aug_eps=0.002,
                                       compute_dtype=precision)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    warmup_s, first_loss = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        out = step(params, state, opt_state, wavs, labels, rng=gen)
        params, state, opt_state = out[:3]
        first_loss = first_loss if first_loss is not None else float(out[3])
        warmup_s.append(time.perf_counter() - t0)

    for w in wrappers.values():
        w.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, accs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        out = step(params, state, opt_state, wavs, labels, rng=gen)
        params, state, opt_state = out[:3]
        losses.append(out[3])
        accs.append(out[4:])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    losses = [first_loss] + [float(v) for v in losses]
    n_adv = TRAIN_BATCH // 2
    rec = {"phase": name, "model": "audionet", "classes": TRAIN_CLASSES,
           "batch": TRAIN_BATCH, "samples": TRAIN_LEN, "train": kind,
           "precision": precision, "optimizer": "adam 1e-3",
           "aug_eps": 0.002 if kind == "natural" else 0.0,
           "warmup_steps_s": warmup_s, "timed_steps": timed,
           "ms_per_step": step_s * 1e3,
           "utts_per_s": TRAIN_BATCH / step_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses,
           "loss_falls": losses[-1] < losses[0],
           "f32_finite": _f32_finite(torch, params, state, opt_state.mu,
                                     opt_state.nu),
           "launches": launches, "plain_calls": plain}
    if kind == "adver":
        clean = wavs[:n_adv]
        dist = max(float((a - clean).abs().max()) for a in advs)
        rec.update({
            "attack": "PGD-10 on half the batch, BN in eval mode",
            "acc_adv": [float(a[0]) for a in accs],
            "acc_nor": [float(a[1]) for a in accs],
            "adv_max_dist": dist,
            "adv_within_eps": dist <= eps + 1e-6,
            "adv_in_range": all(float(a.abs().max()) <= 1.0 for a in advs)})
    else:
        rec["acc"] = [float(a[0]) for a in accs]
        if breakdown:
            rec["breakdown"] = train_breakdown(torch, params, state,
                                               opt_state, wavs, labels, opt)
    rec["profile"] = {
        "note": "one step; wall time includes the profiler's own overhead",
        **profile_call(torch, lambda: step(params, state, opt_state, wavs,
                                           labels, rng=gen),
                       profile_dir, name)}
    emit(rec)
    ok = (rec["loss_falls"] and rec["f32_finite"]
          and rec.get("adv_within_eps", True)
          and rec.get("adv_in_range", True))
    if not ok:
        raise RuntimeError(f"{name} output check failed: {rec}")
    if any(launches.values()) or any(plain.values()):
        raise RuntimeError(f"{name}: launches {launches}, plain calls "
                           f"{plain} (expected all 0)")
    return launches


def phase_train_data(torch, wrappers):
    """The trainer's input path end to end: a synthetic Spk251_train tree
    (251 speakers x 1 WAV of 6 s, ~48 MB) in a temporary directory, the
    label encoder built from its speaker directories as the training CLI
    builds it, then one epoch of f32 natural steps at batch 128 through
    ``Spk251_train(..., wav_length=80000, seed=0).batches(128,
    shuffle=True)``: two batches, 128 and 123 waves, each cropped from the
    dataset's seeded stream.  The native loader must serve both (no
    fall-back to scipy), the loss must be finite, every launch count 0.
    Returns the launch counts."""
    import tempfile
    from speakerguard_tpu_torch.data.dataset import Spk251_train
    from speakerguard_tpu_torch.models.audionet import (init_audionet,
                                                        parse_label_encoder)
    from speakerguard_tpu_torch.models.training import (
        make_natural_train_step)
    from speakerguard_tpu_torch.optim import Adam
    from speakerguard_tpu_torch.utils import native
    from speakerguard_tpu_torch.utils.audio_io import write_wav
    from speakerguard_tpu_torch.utils.kaldi_io import write_label_encoder
    n_spk, length = 251, 96000
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        train_root = os.path.join(root, "Spk251_train")
        for i in range(n_spk):
            d = os.path.join(train_root, f"spk{i:03d}")
            os.makedirs(d)
            write_wav(os.path.join(d, "u0.wav"), (rng.standard_normal(
                length) * 0.1).astype(np.float32))
        write_s = time.perf_counter() - t0
        enc = os.path.join(root, "label_encoder.txt")
        write_label_encoder(enc, sorted(os.listdir(train_root)))
        spk_ids = parse_label_encoder(enc)
        params, state = init_audionet(np.random.default_rng(0), len(spk_ids),
                                      device="cuda")
        opt = Adam(1e-3)
        opt_state = opt.init(params)
        step = make_natural_train_step(opt, aug_eps=0.002)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        train = Spk251_train(spk_ids, root, wav_length=TRAIN_LEN, seed=0)
        for w in wrappers.values():
            w.reset_counts()
        sizes, losses, load_s = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = train.batches(TRAIN_BATCH, shuffle=True)
        while True:
            t1 = time.perf_counter()
            try:
                wavs, labels = next(batches)
            except StopIteration:
                break
            load_s.append(time.perf_counter() - t1)
            x = torch.tensor(wavs[:, 0, :], device="cuda")
            y = torch.tensor(labels, device="cuda")
            params, state, opt_state, loss, _ = step(
                params, state, opt_state, x, y, rng=gen)
            sizes.append(int(x.shape[0]))
            losses.append(loss)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    plain = {k: w.plain_calls for k, w in wrappers.items()}
    losses = [float(v) for v in losses]
    rec = {"phase": "slice_train_data", "speakers": n_spk,
           "file_samples": length, "wav_length": TRAIN_LEN,
           "write_s": write_s, "batch_sizes": sizes,
           "batch_load_s": load_s, "epoch_s": epoch_s, "losses": losses,
           "loader_counts": dict(train.loader_counts),
           "native_library": native.library_path(),
           "native_build_error": native.build_error(),
           "launches": launches, "plain_calls": plain}
    emit(rec)
    ok = (sizes == [TRAIN_BATCH, n_spk - TRAIN_BATCH]
          and train.loader_counts == {"native": 2, "scipy": 0}
          and all(np.isfinite(losses)))
    if not ok:
        raise RuntimeError(f"slice_train_data failed: {rec}")
    if any(launches.values()) or any(plain.values()):
        raise RuntimeError(f"slice_train_data: launches {launches}, plain "
                           f"calls {plain} (expected all 0)")
    return launches


def phase_train_slices(torch, wrappers, profile_dir):
    """train_small_reference, then the three training slices at the JAX
    bench's point, then the input path.  Returns {slice: launch counts}."""
    phase_train_small_reference(torch)
    out = {}
    for name, kind, precision, timed in (
            ("slice_train_natural", "natural", "f32", 5),
            ("slice_train_natural_bf16", "natural", "bf16", 5),
            ("slice_train_adver", "adver", "f32", 3)):
        out[name] = run_train_slice(torch, name, wrappers, kind, precision,
                                    timed, profile_dir,
                                    breakdown=name == "slice_train_natural")
        torch.cuda.empty_cache()
    out["slice_train_data"] = phase_train_data(torch, wrappers)
    return out


# ---------------------------------------------------------------------------
# The evaluation CLIs, in process, on a world written to a temporary
# directory (phases cli_xv, cli_iv, cli_audionet)
# ---------------------------------------------------------------------------

CLI_SPK, CLI_TEST_UTTS, CLI_IMPOSTERS, CLI_LEN = 10, 4, 5, 48000
CLI_EPS, CLI_LSB = 0.002, 1.0 / 32768.0


def write_cli_world(root):
    """Spk10-shaped folders under ``root``: Spk10_enroll (10 speakers x 2
    utterances), Spk10_test (10 x 4) and Spk10_imposter (5 other speakers x
    2), 3 s each, from numpy seed 0.  A speaker's utterances share one base
    wave plus their own noise, so that enrollment has something to find."""
    from speakerguard_tpu_torch.utils.audio_io import write_wav
    rng = np.random.default_rng(0)
    voices = rng.uniform(-0.3, 0.3, (CLI_SPK + CLI_IMPOSTERS, CLI_LEN))
    for name, speakers, utts in (
            ("Spk10_enroll", range(CLI_SPK), 2),
            ("Spk10_test", range(CLI_SPK), CLI_TEST_UTTS),
            ("Spk10_imposter", range(CLI_SPK, CLI_SPK + CLI_IMPOSTERS), 2)):
        for s in speakers:
            spk = f"spk{s}" if s < CLI_SPK else f"imp{s - CLI_SPK}"
            d = os.path.join(root, name, spk)
            os.makedirs(d)
            for u in range(utts):
                wave = voices[s] + 0.05 * rng.standard_normal(CLI_LEN)
                write_wav(os.path.join(d, f"{spk}-{u}.wav"),
                          np.clip(wave, -0.99, 0.99).astype(np.float32))


def _row(values):
    return " ".join(map("{:.6f}".format, np.ravel(values)))


def write_kaldi_plda(d, plda, emb_mean, transform_mat):
    """plda.txt, mean.vec and transform.txt in the Kaldi text layouts the
    port's utils/kaldi_io.py parses (reference model/_iv_plda/plda.py:27-51,
    model/utils.py:50-80).  Returns their paths."""
    mean, transform, psi = (t.cpu().double().numpy() for t in plda)
    paths = [os.path.join(d, n) for n in ("plda.txt", "mean.vec",
                                          "transform.txt")]
    with open(paths[0], "w") as f:
        f.write(f"<Plda> [ {_row(mean)} ]\n[\n")
        for r in transform:
            f.write(f"r  {_row(r)} x\n")
        f.write(f"[ {_row(psi)} ]\n")
    with open(paths[1], "w") as f:
        f.write(f"[ {_row(emb_mean.cpu().double().numpy())} ]\n")
    mat = transform_mat.cpu().double().numpy()
    with open(paths[2], "w") as f:
        f.write("[\n")
        for i, r in enumerate(mat):
            f.write(f" {_row(r)} {']' if i == len(mat) - 1 else ''}\n")
    return paths


def write_kaldi_iv(d, params):
    """final_ubm.txt (the full-covariance UBM) and final_ie.txt (the
    i-vector extractor) of ``params`` in the Kaldi text layouts the port
    parses (reference gmm.py:31-81, ivector_extract.py:28-70), plus the
    PLDA files.  Returns the five paths in CLI order (-gmm -extractor
    -plda -mean -transform)."""
    g, e = params.fgmm, params.extractor
    invcov = g.invcovars.cpu().double().numpy()
    c, dim = invcov.shape[:2]
    gmm = os.path.join(d, "final_ubm.txt")
    with open(gmm, "w") as f:
        f.write("<DiagGMM>\n")
        f.write(f"<GCONSTS> [ {_row(g.gconsts.cpu().double().numpy())} ]\n")
        f.write(f"<WEIGHTS> [ {_row(g.weights.cpu().double().numpy())} ]\n")
        f.write("<MEANS_INVCOVARS> [\n")
        for r in g.means_invcovars.cpu().double().numpy():
            f.write(f"r  {_row(r)} x\n")
        f.write("<INV_COVARS> [\n")
        for i in range(c):
            for j in range(dim):
                f.write(f"{_row(invcov[i, j, :j + 1])} \n")
            f.write(" ]\n")
        f.write("</DiagGMM>\n")
    m = e.extractor_matrix.cpu().double().numpy()
    sig = e.sigma_inv.cpu().double().numpy()
    ie = os.path.join(d, "final_ie.txt")
    with open(ie, "w") as f:
        f.write(f"<w_vec> [ {_row(np.ones(c))} ]\n<M> [\n")
        for i in range(c):  # savetxt formats ~3x faster than _row
            np.savetxt(f, m[i, :-1], fmt="%.6f")
            f.write(f"{_row(m[i, -1])} ]\n [\n")
        f.write("<SigmaInv> [\n")
        for i in range(c):
            for j in range(dim):
                f.write(f"{_row(sig[i, j, :j + 1])}\n")
            f.write(" ]\n")
        f.write(f"<IvectorOffset> {float(e.offset):.6f}\n")
    return [gmm, ie, *write_kaldi_plda(d, params.plda, params.emb_mean,
                                       params.transform_mat)]


def write_tdnn_state(path, tdnn):
    """The reference TDNN checkpoint (its state-dict names; the port keeps
    its layouts) of ``tdnn`` through torch.save."""
    import torch
    state = {}
    for i in range(5):
        state[f"tdnn{i + 1}.weight"] = tdnn.conv_w[i]
        state[f"tdnn{i + 1}.bias"] = tdnn.conv_b[i]
        state[f"bn_tdnn{i + 1}.running_mean"] = tdnn.bn_tdnn[i].mean
        state[f"bn_tdnn{i + 1}.running_var"] = tdnn.bn_tdnn[i].var
    for n in ("fc1", "fc2", "fc3"):
        state[f"{n}.weight"] = getattr(tdnn, f"{n}_w")
        state[f"{n}.bias"] = getattr(tdnn, f"{n}_b")
    for n in ("bn_fc1", "bn_fc2"):
        state[f"{n}.running_mean"] = getattr(tdnn, n).mean
        state[f"{n}.running_var"] = getattr(tdnn, n).var
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def _cli_call(torch, wrappers, mod, argv):
    """``mod.main(mod.parse_args(argv))`` with its standard output
    captured: (result, output, seconds, launch counts, plain calls), the
    counts set to 0 just before and read just after."""
    import contextlib
    import io
    args = mod.parse_args(argv)
    for w in wrappers.values():
        w.reset_counts()
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = mod.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (result, out.getvalue(), seconds,
            {k: w.launches for k, w in wrappers.items()},
            {k: w.plain_calls for k, w in wrappers.items()})


def recording_attacker(attack_main, torch, seed):
    """Wrap ``attack_main.make_attacker`` so that each attack keeps its
    float adversarial audio and the dither of its final evaluation.  The
    dither comes through the PGD hook from a generator seeded as the CLI
    seeds the batch's own (``seeded_generator(device, seed, index)``), in
    the order the attack draws it, so the run draws what the CLI draws
    unhooked.  Returns (the list of (names order, adver, final dither or
    None) per batch, the restore function)."""
    from speakerguard_tpu_torch.cli.common import seeded_generator
    batches = []
    orig = attack_main.make_attacker

    def make(args, model):
        atk = orig(args, model)
        attack = atk.attack

        def attack_rec(x, y, rng=None):
            gen = seeded_generator(x.device, seed, args.start + len(batches))
            final = []

            def dither_fn(restart, it, e, shape):
                noise = torch.randn(shape, generator=gen, device=x.device)
                if it == atk.max_iter:
                    final.append(noise)
                return noise
            atk.dither_fn = dither_fn
            adver, success = attack(x, y, rng=rng)
            batches.append((adver, final[-1] if final else None))
            return adver, success
        atk.attack = attack_rec
        return atk
    attack_main.make_attacker = make
    return batches, lambda: setattr(attack_main, "make_attacker", orig)


def cli_cross_check(torch, model, spk_ids, names, batches, attack_res,
                    test_res, adver_dir, data_root):
    """The checks of an attack_main run and test_attack's read of it:
    every adversarial wave within eps of its source after the int16
    write-back (one LSB of slack); one WAV per test utterance; attack_main's
    success of each wave equal to an exact re-decision of its float audio
    with its final evaluation's dither replayed, and test_attack's
    decision equal to an undithered decision of the read-back wave.  So
    where the two disagree on a wave, its decision flips between the
    attack's final (dithered) evaluation and the undithered decision of
    the int16 wave; those waves are listed.  Returns the record."""
    from speakerguard_tpu_torch.utils.audio_io import read_wav
    written = sorted(os.path.relpath(os.path.join(r, f), adver_dir)
                     for r, _, fs in os.walk(adver_dir) for f in fs
                     if f.endswith(".wav"))
    want_tree = sorted(os.path.join(n.split("-")[0], n + ".wav")
                       for n in names)
    src_dir = os.path.join(data_root, "Spk10_test")
    dev_eps = max(float(np.abs(read_wav(os.path.join(adver_dir, rel))
                               - read_wav(os.path.join(src_dir, rel))).max())
                  for rel in written)
    true = {n: spk_ids.index(n.split("-")[0]) for n in names}
    order = sorted(names)  # the dataset's order: speaker dirs, then files
    replay, readback = {}, {}
    with torch.no_grad():
        start = 0
        for adver, dither in batches:
            b = adver.shape[0]
            batch_names = order[start:start + b]
            start += b
            rng = None if dither is None else (lambda shape, d=dither: d)
            d, _ = model.make_decision(adver.reshape(b, -1), rng=rng)
            replay.update(zip(batch_names, d.tolist()))
        for n in names:
            wav = read_wav(os.path.join(adver_dir, n.split("-")[0],
                                        n + ".wav"))
            d, _ = model.make_decision(torch.tensor(wav[None],
                                                    device=model.device))
            readback[n] = int(d[0])
    attack_ok = {n: (replay[n] != true[n]) == attack_res["success"][n]
                 for n in names}
    readback_ok = {n: readback[n] == test_res["decisions"][n]
                   for n in names}
    differ = [n for n in names if attack_res["success"][n]
              != (test_res["decisions"][n] != true[n])]
    return {"tree_ok": written == want_tree, "waves": len(written),
            "max_abs_dev": dev_eps,
            "within_eps": dev_eps <= CLI_EPS + CLI_LSB + 1e-7,
            "attack_success_replayed": all(attack_ok.values()),
            "test_attack_readback": all(readback_ok.values()),
            "differ": differ,
            "differ_flip": {n: {"attack_final": replay[n],
                                "readback": readback[n], "true": true[n]}
                            for n in differ}}


def phase_cli_kernels(torch, chol):
    """cholesky_rt at the shapes cli_iv gives it: B = 40 matrices of 600 x
    600 (attack_main's batch: f32 on its exact evaluations, bf16 input with
    bf16_updates on its fast iterations) and B = 1 (every single-utterance
    evaluation of the other CLIs), each against its plain version at the
    main-shape bars (blocked residual and plain error at 1e-5), with
    CUDA-event ms and the bound.  Returns the B = 40 f32 record."""
    n, tol, out = 600, 1e-5, None
    for case, b, dtype, upd in (
            ("cli_b40_f32", 40, torch.float32, False),
            ("cli_b40_bf16_input_updates", 40, torch.bfloat16, True),
            ("cli_b1_f32", 1, torch.float32, False)):
        a = spd_batch(torch, "dominant", b, n, seed=n, dtype=dtype)
        got = chol.cholesky_rt(a, bf16_updates=upd)
        torch.cuda.synchronize()
        want = chol.cholesky_rt_plain(a, bf16_updates=upd)
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        lower_zero = bool(torch.all(torch.tril(got, -1) == 0))
        resid = chol.blocked_residual(a, got, upd)
        rec = {"phase": "kernel", "kernel": "cholesky_rt", "case": case,
               "input": "dominant", "shape": [b, n, n],
               "dtype": str(dtype), "bf16_updates": upd,
               "max_abs_err": abs_err, "max_rel_err": rel_err,
               "tolerance_vs_plain": tol, "blocked_residual": resid,
               "tolerance_residual": tol, "strictly_lower_zero": lower_zero,
               "ms": cuda_ms(lambda: chol.cholesky_rt(a, upd), 3, 20),
               "plain_ms": cuda_ms(lambda: chol.cholesky_rt_plain(a, upd),
                                   1, 2),
               "library_ms": cuda_ms(lambda: torch.linalg.cholesky(
                   a.float(), upper=True), 3, 20)}
        rec["bound_ms"], rec["bound_by"] = chol_bound_ms(
            b, n, a.element_size(), upd, chol.NB)
        emit(rec)
        if not (lower_zero and resid <= tol and rel_err <= tol):
            raise RuntimeError(f"cholesky_rt at the cli_iv shape: {rec}")
        out = out or rec
        del a, got, want
    return out


def run_cli_phase(torch, name, wrappers, system, model_args, attack,
                  expected, root, full=True):
    """One system through the five CLIs (``full``) or attack_main and
    test_attack alone, on the world under ``root``: enroll, set_threshold
    (its dict printed), specify_target_label (random), attack_main
    (-batch_size 40 -wav_length 48000 -task CSI, ``attack``), attack_main
    again (every batch must print "Exists, Skip"), test_attack on the
    adversarial directory, then (``full``) in imperceptibility mode
    against Spk10_test.  ``expected`` maps each CLI to its launch counts
    (every other count and every plain call 0).  Returns attack_main's
    launch counts."""
    from speakerguard_tpu_torch.cli import (attack_main, enroll,
                                            set_threshold,
                                            specify_target_label,
                                            test_attack)
    from speakerguard_tpu_torch.cli.common import build_model
    data = os.path.join(root, "data")
    mdir = os.path.join(root, f"model_{name}")
    mf = os.path.join(mdir, system, f"speaker_model_{system}")
    model_file = ["-model_file", mf] if full else []
    adv = os.path.join(root, f"adver_{name}")
    names = sorted(os.path.splitext(f)[0]
                   for _, _, fs in os.walk(os.path.join(data, "Spk10_test"))
                   for f in fs)
    rec = {"phase": name, "system": system, "utterances": len(names),
           "samples": CLI_LEN, "attack": attack, "cli": {}}
    calls = []
    if full:
        calls += [
            ("enroll", enroll, ["-model_dir", mdir, "-root", data, system]
             + model_args),
            ("set_threshold", set_threshold, ["-root", data, system]
             + model_args + model_file),
            ("specify_target_label", specify_target_label, [
                "-root", data, "-name", "Spk10_test", "-save_path",
                os.path.join(root, f"targets_{name}.pkl"), system]
             + model_args + model_file)]
    attack_argv = ["-root", data, "-name", "Spk10_test", "-des", adv,
                   "-batch_size", "40", "-wav_length", str(CLI_LEN),
                   "-task", "CSI", system] + model_args + model_file + attack
    calls += [("attack_main", attack_main, attack_argv),
              ("attack_main_resume", attack_main, attack_argv),
              ("test_attack", test_attack, ["-root", root, "-name",
                                            os.path.basename(adv), system]
               + model_args + model_file)]
    if full:
        calls.append(("test_attack_imperceptibility", test_attack, [
            "-root", root, "-name", os.path.basename(adv), "-root_ori",
            data, "-name_ori", "Spk10_test", system] + model_args
            + model_file))
    results, bad = {}, {}
    for cli, mod, argv in calls:
        restore = None
        if cli == "attack_main":
            batches, restore = recording_attacker(attack_main, torch, 0)
            torch.cuda.reset_peak_memory_stats()
        try:
            res, text, secs, launches, plain = _cli_call(torch, wrappers,
                                                         mod, argv)
        finally:
            if restore is not None:
                restore()
        results[cli] = res
        entry = {"seconds": secs, "launches": launches,
                 "plain_calls": plain}
        want = {k: expected.get(cli, {}).get(k, 0) for k in wrappers}
        if launches != want or any(plain.values()):
            bad[cli] = {"launches": launches, "expected": want,
                        "plain_calls": plain}
        if cli == "set_threshold":
            entry["result"] = res
            print(json.dumps({"phase": name, "set_threshold": res}),
                  flush=True)
        if cli == "attack_main":
            entry.update(success_rate=res["success_rate"],
                         attack_s=res["attack_s"],
                         peak_mem_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30)
            iters = int(attack[attack.index("-max_iter") + 1]) if (
                "-max_iter" in attack) else (10 if attack[0] == "PGD" else 1)
            entry["iterations"] = iters
            entry["ms_per_iter"] = res["attack_s"] * 1e3 / iters
            attack_launches = launches
        if cli == "attack_main_resume":
            entry["skips"] = text.count("Exists, Skip")
            if entry["skips"] != 1 or res["success"]:
                bad[cli] = {"skips": entry["skips"]}
        if cli.startswith("test_attack"):
            entry.update(acc=res["acc"], untargeted_asr=res["untargeted_asr"])
            if res["imperceptibility"] is not None:
                entry["imperceptibility_means"] = dict(zip(
                    ("L2", "L0", "L1", "Linf", "SNR", "PESQ", "STOI"),
                    res["imperceptibility"]))
        rec["cli"][cli] = entry
    args = attack_main.parse_args(attack_argv)
    base, model, _ = build_model(args)
    rec["check"] = cli_cross_check(torch, model, base.spk_ids, names,
                                   batches, results["attack_main"],
                                   results["test_attack"], adv, data)
    rec["attack_success_rate"] = results["attack_main"]["success_rate"]
    rec["test_attack_untargeted_asr"] = results["test_attack"][
        "untargeted_asr"]
    emit(rec)
    chk = rec["check"]
    ok = (chk["tree_ok"] and chk["within_eps"]
          and chk["attack_success_replayed"] and chk["test_attack_readback"]
          and not bad)
    if not ok:
        raise RuntimeError(f"{name} failed: {bad or chk}")
    return attack_launches


def phase_cli(torch, wrappers):
    """The evaluation workflow through the port's CLIs, in process with
    their default -device cuda, on one world written to a temporary
    directory: cli_xv (xv-PLDA at full width from a reference TDNN state
    dict and Kaldi text), cli_iv (iv-PLDA at D=72, IV=600, R=200 and C=256
    from Kaldi text: cholesky_rt on every model evaluation), cli_audionet
    (AudioNet CSI-NE from the port's checkpoint: FGSM).  Returns {phase:
    attack_main's launch counts}."""
    import tempfile
    from speakerguard_tpu_torch.models.audionet import init_audionet
    from speakerguard_tpu_torch.models.iv_plda import random_iv_plda_params
    from speakerguard_tpu_torch.models.training import save_checkpoint
    from speakerguard_tpu_torch.models.xv_plda import random_xv_plda_params
    from speakerguard_tpu_torch.utils.kaldi_io import write_label_encoder
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_cli_world(os.path.join(root, "data"))
        world_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        xv = random_xv_plda_params(np.random.default_rng(0), device="cuda")
        ckpt = os.path.join(root, "xvecTDNN.ckpt")
        write_tdnn_state(ckpt, xv.tdnn)
        xv_files = write_kaldi_plda(root, xv.plda, xv.emb_mean,
                                    xv.transform_mat)
        del xv
        emit({"phase": "cli_setup", "world_s": world_s,
              "xv_write_s": time.perf_counter() - t0})
        # an utterance a model evaluation: 20 enrollment embeddings and 10
        # x 36 non-target scores; 40 test + 10 imposter decisions; 40
        # decisions; PGD-10 (each iteration and the final evaluation); 40
        # decisions, twice
        evals = {"enroll": 2 * CLI_SPK + CLI_SPK * (CLI_SPK - 1)
                 * CLI_TEST_UTTS,
                 "set_threshold": CLI_SPK * CLI_TEST_UTTS + 2 * CLI_IMPOSTERS,
                 "specify_target_label": CLI_SPK * CLI_TEST_UTTS,
                 "attack_main": 10 + 1,
                 "test_attack": CLI_SPK * CLI_TEST_UTTS,
                 "test_attack_imperceptibility": CLI_SPK * CLI_TEST_UTTS}
        out["cli_xv"] = run_cli_phase(
            torch, "cli_xv", wrappers, "xv_plda",
            ["-extractor", ckpt, "-plda", xv_files[0], "-mean", xv_files[1],
             "-transform", xv_files[2]], ["PGD"], {}, root)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        iv = random_iv_plda_params(np.random.default_rng(0), 256, 72, 600,
                                   200, device="cuda")
        iv_dir = os.path.join(root, "iv")
        os.makedirs(iv_dir)
        iv_files = write_kaldi_iv(iv_dir, iv)
        emit({"phase": "cli_iv_setup", "C": iv.fgmm.num_gaussians,
              "D": iv.fgmm.dim, "IV": int(iv.extractor.extractor_matrix
                                          .shape[2]),
              "R": iv.plda.dim, "write_s": time.perf_counter() - t0,
              "text_mb": sum(os.path.getsize(p) for p in iv_files) / 1e6})
        del iv
        out["cli_iv"] = run_cli_phase(
            torch, "cli_iv", wrappers, "iv_plda",
            [a for flag, p in zip(("-gmm", "-extractor", "-plda", "-mean",
                                   "-transform"), iv_files)
             for a in (flag, p)], ["PGD"],
            {cli: {"cholesky_rt": n} for cli, n in evals.items()}, root)
        torch.cuda.empty_cache()

        params, state = init_audionet(np.random.default_rng(0), CLI_SPK,
                                      device="cuda")
        an_ckpt = os.path.join(root, "audionet.ckpt")
        save_checkpoint(an_ckpt, params, state)
        enc = os.path.join(root, "label_encoder.txt")
        write_label_encoder(enc, [f"spk{i}" for i in range(CLI_SPK)])
        out["cli_audionet"] = run_cli_phase(
            torch, "cli_audionet", wrappers, "audionet_csine",
            ["-extractor", an_ckpt, "-label_encoder", enc],
            ["FGSM"], {}, root, full=False)
    return out


# ---------------------------------------------------------------------------
# The training CLIs and data parallelism on one card (phases
# train_cli_natural, train_cli_adver, dp_one_card)
# ---------------------------------------------------------------------------

def write_train_world(root):
    """slice_train_data's Spk251_train tree (251 speakers x 1 WAV of 6 s,
    numpy seed 3) and a Spk251_test tree for validation (the same speakers
    x 1 WAV of 3 s, seed 4) under ``root``."""
    from speakerguard_tpu_torch.utils.audio_io import write_wav
    for name, length, seed in (("Spk251_train", 96000, 3),
                               ("Spk251_test", 48000, 4)):
        rng = np.random.default_rng(seed)
        for i in range(TRAIN_CLASSES):
            d = os.path.join(root, name, f"spk{i:03d}")
            os.makedirs(d)
            write_wav(os.path.join(d, "u0.wav"), (rng.standard_normal(
                length) * 0.1).astype(np.float32))


def phase_train_clis(torch, wrappers):
    """train_cli_natural and train_cli_adver: the port's training CLIs in
    process with their default -device cuda at the JAX bench's point (251
    classes, batch 128 of 80,000 samples) over write_train_world's tree.
    natural_train: 2 epochs (batches of 128 and 123) with validation on
    the 251 test waves, then one epoch resumed from its final pickle
    (-start_epoch 2), then one epoch with -ckpt_backend dcp and one more
    resumed from its directory; adver_train: PGD-10, ratio 0.5, 1 epoch,
    -evaluate_adver.  A StageTimer times each run.  Checks: the batch sizes,
    finite losses that fall over the natural run, the checkpoints' epochs
    (read back by the port), the resumed runs' epochs in their logs, the
    dcp directories, every launch count and plain call 0.  Returns {phase:
    launch counts}."""
    import tempfile
    from speakerguard_tpu_torch.cli import adver_train, natural_train
    from speakerguard_tpu_torch.models.training import load_checkpoint
    from speakerguard_tpu_torch.utils.profiling import StageTimer
    timer = StageTimer()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        with timer.stage("write_world"):
            write_train_world(root)
        enc = os.path.join(root, "label_encoder.txt")
        common = ["-root", root, "-label_encoder", enc, "-batch_size",
                  str(TRAIN_BATCH), "-wav_length", str(TRAIN_LEN)]
        base = os.path.join(root, "model_file", "audionet-natural")
        dbase = os.path.join(root, "model_file", "audionet-natural-dcp")
        runs = {}
        for stage, argv in (
                ("natural_2_epochs", ["-num_epoches", "2", "-model_ckpt",
                                      base]),
                ("natural_resume_pickle", [
                    "-num_epoches", "1", "-start_epoch", "2",
                    "-ori_model_ckpt", base, "-evaluate_per_epoch", "0",
                    "-model_ckpt", base + "-resumed"]),
                ("natural_dcp", ["-num_epoches", "1", "-ckpt_backend", "dcp",
                                 "-evaluate_per_epoch", "0", "-model_ckpt",
                                 dbase]),
                ("natural_resume_dcp", [
                    "-num_epoches", "1", "-start_epoch", "1",
                    "-ckpt_backend", "dcp", "-ori_model_ckpt", dbase,
                    "-evaluate_per_epoch", "0", "-model_ckpt",
                    dbase + "-resumed"])):
            with timer.stage(stage):
                runs[stage] = _cli_call(torch, wrappers, natural_train,
                                        common + argv)
        first = runs["natural_2_epochs"][0]
        with open(base + "-resumed.log") as f:
            resumed_log = f.read().splitlines()
        with open(dbase + "-resumed.log") as f:
            dcp_log = f.read().splitlines()
        epochs = {"final": load_checkpoint(base, "cuda")[3],
                  "resumed": load_checkpoint(base + "-resumed", "cuda")[3]}
        launches = {k: sum(r[3][k] for r in runs.values()) for k in wrappers}
        plain = {k: sum(r[4][k] for r in runs.values()) for k in wrappers}
        rec = {"phase": "train_cli_natural", "classes": TRAIN_CLASSES,
               "batch": TRAIN_BATCH, "samples": TRAIN_LEN,
               "stages_s": dict(timer.totals),
               "report": timer.report().splitlines(),
               # after the first epoch, whose two steps autotune cuDNN
               "ms_per_step": 1e3 * statistics.median(
                   first["step_s"][2:] + [t for k, r in runs.items()
                                          if k != "natural_2_epochs"
                                          for t in r[0]["step_s"]]),
               "step_s": {k: r[0]["step_s"] for k, r in runs.items()},
               "losses": {k: r[0]["losses"] for k, r in runs.items()},
               "val_accs": first["val_accs"],
               "batch_sizes": [len(lab) for lab in first["labels"]],
               "checkpoint_epochs": epochs,
               "resumed_log": resumed_log, "dcp_resumed_log": dcp_log,
               "dcp_dirs": [os.path.isdir(dbase + sfx)
                            for sfx in ("_0", "", "-resumed")],
               "launches": launches, "plain_calls": plain}
        emit(rec)
        losses = first["losses"]
        ok = (rec["batch_sizes"] == [TRAIN_BATCH,
                                     TRAIN_CLASSES - TRAIN_BATCH] * 2
              and all(np.isfinite(v).all() for v in rec["losses"].values())
              and losses[-1] < losses[0] and len(first["val_accs"]) == 2
              and epochs == {"final": 2, "resumed": 3}
              and resumed_log[0].startswith("EPOCH 2/3")
              and dcp_log[0].startswith("EPOCH 1/2")
              and all(rec["dcp_dirs"]))
        if not ok:
            raise RuntimeError(f"train_cli_natural failed: {rec}")
        if any(launches.values()) or any(plain.values()):
            raise RuntimeError(f"train_cli_natural: launches {launches}, "
                               f"plain calls {plain} (expected all 0)")
        out["train_cli_natural"] = launches

        abase = os.path.join(root, "model_file", "audionet-adver")
        with timer.stage("adver_1_epoch"):
            res, _, _, launches, plain = _cli_call(
                torch, wrappers, adver_train,
                common + ["-num_epoches", "1", "-max_iter", "10", "-ratio",
                          "0.5", "-evaluate_adver", "-model_ckpt", abase])
        rec = {"phase": "train_cli_adver", "classes": TRAIN_CLASSES,
               "batch": TRAIN_BATCH, "samples": TRAIN_LEN,
               "attack": "PGD-10", "ratio": 0.5,
               "seconds": timer.totals["adver_1_epoch"],
               # one epoch: each step is its batch shape's first, so its
               # time includes cuDNN's autotuning (the steady step is
               # slice_train_adver's)
               "step_s": res["step_s"],
               "losses": res["losses"], "accs_adv": res["accs_adv"],
               "accs_nor": res["accs_nor"], "val_accs": res["val_accs"],
               "val_adver_accs": res["val_adver_accs"],
               "checkpoint_epoch": load_checkpoint(abase, "cuda")[3],
               "launches": launches, "plain_calls": plain}
        emit(rec)
        ok = (len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
              and len(res["val_adver_accs"]) == 1
              and rec["checkpoint_epoch"] == 1)
        if not ok:
            raise RuntimeError(f"train_cli_adver failed: {rec}")
        if any(launches.values()) or any(plain.values()):
            raise RuntimeError(f"train_cli_adver: launches {launches}, "
                               f"plain calls {plain} (expected all 0)")
        out["train_cli_adver"] = launches
    return out


def _dp_leaf_errors(got, want):
    """Each leaf's largest error over its scale, the larger of its largest
    |entry| and 1% of its tree's (tests/test_torch_parallel.py's rule)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), 1e-2 * top)
            for n, w in want.items()}


# the AudioNet leaves after its last max-pool (block 7, conv8, and the fc
# head): a near tie in an earlier pool's window cannot reroute their
# gradient
AFTER_LAST_POOL = ("conv_w__6", "conv_b__6", "gamma__6", "beta__6", "fc_w",
                   "fc_b")


def phase_dp_one_card(torch, profile_dir):
    """dp_one_card: the collective code path of parallel/ on one card; no
    scaling is measured (two ranks share the card).  Two ranks spawned on
    cuda:0 with gloo (NCCL refuses two ranks on one device) run
    parallel/rank_checks.py: the DP natural step at global batch 128 x
    80,000 (64 a rank, 251 classes, SGD 0.1, augmentation on), in float32
    and in float64, and PGD-10 with mesh= on iv-PLDA at full width with
    FastPath() and batch 64 x 3 s (32 a rank: the shared top-K is
    all-reduced, cholesky_rt runs on each rank, once an iteration and once
    for the exact final evaluation: 11).  Then the float32 DP step once
    more on one rank under nccl.  Each is held against the same run in
    this process with no group, at the CPU test's bars: loss rtol 1e-6,
    the accuracy equal, BN state atol 1e-6, parameters within 1e-5 of
    their scale.  The float64 step holds every parameter to that bar; the
    float32 steps hold the leaves after the last max-pool to it, and
    report the others: in float32 a rank's rounding (its half of the
    batch, the all-reduced BN sums) can flip the larger of a near-tied
    pair in some pool window at this size and reroute that window's
    gradient (4.7e-4 of scale on conv_w__3 in one run on an NVIDIA H100
    80GB HBM3, 700 W), while in float64 the rounding is 2^29 times finer
    and the same code path agrees on every leaf.  The attack's success
    list and top-K selection equal, the launches per rank as above with no
    plain call.  With --profile, rank 0 traces one float32 DP step into
    DIR/dp_trace.  Returns {"dp_one_card": rank 0's launch counts}."""
    from speakerguard_tpu_torch.models.base import FastPath
    from speakerguard_tpu_torch.parallel import rank_checks as rc
    from speakerguard_tpu_torch.parallel.mesh import spawn
    step_args = ("cuda", TRAIN_CLASSES, TRAIN_BATCH, TRAIN_LEN)
    pgd_args = ("cuda", 64, 48000, (2048, 72, 600, 200), 10, FastPath())
    t0 = time.perf_counter()
    one_step = rc.dp_natural_step(*step_args)
    one_step64 = rc.dp_natural_step(*step_args, f64=True)
    one_pgd = rc.sharded_pgd_iv(*pgd_args)
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    trace_dir = os.path.join(profile_dir, "dp_trace") if profile_dir else None
    t0 = time.perf_counter()
    ranks = spawn(rc.dp_one_card, 2, (step_args, pgd_args, trace_dir),
                  backend="gloo", devices=["cuda:0", "cuda:0"],
                  timeout_s=600)
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = spawn(rc.dp_natural_step, 1, step_args, backend="nccl",
                    devices=["cuda:0"], timeout_s=600)
    nccl_s = time.perf_counter() - t0

    def step_check(got, want, dtype):
        return {"dtype": dtype, "loss": got["loss"], "acc": got["acc"],
                "acc_equal": got["acc"] == want["acc"],
                "loss_rel_err": abs(got["loss"] - want["loss"])
                / abs(want["loss"]),
                "param_errors": _dp_leaf_errors(got["params"],
                                                want["params"]),
                "state_max_err": max(float(np.abs(got["state"][n] - w).max())
                                     for n, w in want["state"].items()),
                "step_s": got["seconds"], "world": got["world"]}
    steps = ([step_check(r[0], one_step, "f32") for r in ranks]
             + [step_check(nccl, one_step, "f32")]
             + [step_check(r[1], one_step64, "f64") for r in ranks])
    expected = {"cholesky_rt": 11}
    pgds = [r[2] for r in ranks]
    rec = {"phase": "dp_one_card", "backend_two_ranks": "gloo",
           "backend_one_rank": "nccl", "one_process_s": one_s,
           "two_ranks_s": two_s, "nccl_one_rank_s": nccl_s,
           "one_process_step": {"loss": one_step["loss"],
                                "acc": one_step["acc"],
                                "step_s": one_step["seconds"]},
           "one_process_step_f64": {"loss": one_step64["loss"],
                                    "acc": one_step64["acc"],
                                    "step_s": one_step64["seconds"]},
           "steps": steps,
           "pgd_one_process": {k: one_pgd[k] for k in (
               "success", "launches", "plain_calls", "max_dist")},
           "pgd_ranks": [{k: p[k] for k in ("success", "launches",
                                            "plain_calls", "max_dist",
                                            "world")} for p in pgds],
           "launches_expected_per_rank": expected,
           "trace_dir": trace_dir}
    emit(rec)
    held = {"f32": AFTER_LAST_POOL, "f64": tuple(one_step64["params"])}
    ok = (all(s["loss_rel_err"] <= 1e-6 and s["acc_equal"]
              and max(s["param_errors"][n] for n in held[s["dtype"]])
              <= 1e-5
              and s["state_max_err"] <= 1e-6 for s in steps)
          and [s["world"] for s in steps] == [2, 2, 1, 2, 2]
          and all(p["success"] == one_pgd["success"] and p["finite"]
                  and p["max_dist"] <= 0.002 + 1e-6
                  and p["topk_sel"] == one_pgd["topk_sel"]
                  and p["world"] == 2 for p in pgds))
    if not ok:
        raise RuntimeError(f"dp_one_card failed: {rec}")
    for p in pgds + [one_pgd]:
        wrong = {k: v for k, v in p["launches"].items()
                 if v != expected.get(k, 0)}
        if wrong or any(p["plain_calls"].values()):
            raise RuntimeError(f"dp_one_card: launches {p['launches']} "
                               f"(expected {expected} a rank), plain calls "
                               f"{p['plain_calls']}")
    launches = dict(pgds[0]["launches"], adpcm=0)
    return {"dp_one_card": launches}


def phase_rounds(torch, models, x, rounds, iters=10):
    """ms per PGD iteration of the given models, ``rounds`` times each, the
    order rotated every round so that no model always runs first."""
    from speakerguard_tpu_torch.attacks import PGD
    names = list(models)
    with torch.no_grad():
        labels = models[names[0]].make_decision(x)[0].long()
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            atk = PGD(models[n], task="CSI", epsilon=0.002,
                      step_size=0.0004, max_iter=iters, loss="Entropy")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            atk.attack(x, labels, rng=0)
            torch.cuda.synchronize()
            times[n].append((time.perf_counter() - t0) * 1e3 / iters)
    emit({"phase": "rounds", "iterations": iters, "ms_per_iter": times,
          "median": {n: statistics.median(v) for n, v in times.items()}})


def profile_call(torch, fn, out_dir, name):
    """One call of ``fn`` under torch.profiler: its wall time, the device
    time and busy share, and the top device ops; with ``out_dir``, the
    table in out_dir/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    table = events.table(row_limit=-1)
    # the table's footer sums kernel time once (per-op rows also carry the
    # time of the kernels they launch, so summing rows counts it twice)
    footer = [ln for ln in table.splitlines()
              if ln.startswith("Self CUDA time total:")]
    device_ms = parse_ms(footer[0].split(":")[1]) if footer else None

    def dev_us(e):  # the attribute was renamed across torch versions
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(table)
    top = sorted(events, key=lambda e: -dev_us(e))
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": (device_ms / wall_ms if device_ms
                                  else None),
            "top": [{"name": e.key[:60], "self_device_ms": dev_us(e) / 1e3,
                     "count": e.count} for e in top[:15]]}


def profile_one_iteration(torch, model, x, labels, out_dir, name,
                          atk=None, note=None):
    """A torch.profiler table of one attack on ``model``: by default one
    PGD iteration plus the exact final evaluation."""
    from speakerguard_tpu_torch.attacks import PGD
    if atk is None:
        atk = PGD(model, task="CSI", epsilon=0.002, step_size=0.0004,
                  max_iter=1, loss="Entropy")
        note = "one PGD iteration plus the exact final evaluation"
    atk.attack(x, labels, rng=0)
    rec = profile_call(torch, lambda: atk.attack(x, labels, rng=0), out_dir,
                       name)
    emit({"phase": "profile", "slice": name, "iterations_profiled": 1,
          "note": note + "; wall time includes the profiler's own "
                         "overhead", **rec})


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import speakerguard_tpu_torch  # noqa: F401  (TF32 off)
        from speakerguard_tpu_torch.ops import _build, chol
        from speakerguard_tpu_torch.ops import adpcm, gmm_loglike, gmm_stats
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    profile_dir = (argv[argv.index("--profile") + 1]
                   if "--profile" in argv else None)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])

    t0 = time.perf_counter()
    sources = ("chol", "gmm", "gmm_stats_fwd", "gmm_stats_bwd", "adpcm")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "Compiling entry" in ln
                          or "spill" in ln]
                    for src, log in logs.items()}})

    loglike_launch_recs = phase_fused_loglike_launches(torch)
    launch_recs, siren_launch_recs = phase_stats_fwd_launches(torch)
    bwd_launch_recs = phase_stats_bwd_launches(torch)
    recs = {"cholesky_rt": phase_kernels(torch, chol),
            "cholesky_rt_dinv": phase_chol_dinv(torch, chol),
            "chol_solve": phase_chol_solve(torch, chol)}
    gmm_main, defended_recs = phase_gmm_kernels(torch)
    recs.update(gmm_main)
    phase_small_reference(torch)
    phase_xv_blocks(torch)
    phase_xv_small_reference(torch)
    wrappers = {"cholesky_rt": chol.cholesky_rt,
                "cholesky_rt_dinv": chol.cholesky_rt_dinv,
                "chol_solve": chol.chol_solve,
                "fused_loglike": gmm_loglike.fused_loglike,
                "stats_fwd": gmm_stats.stats_fwd,
                "stats_bwd": gmm_stats.stats_bwd,
                "adpcm": adpcm.adpcm}
    launches, models, x = phase_slices(torch, wrappers, profile_dir)
    if "--rounds" in argv:
        phase_rounds(torch, {n: models[n] for n in (
            "slice_fast_default", "slice_chol_dinv", "slice_chol_solve")},
            x, int(argv[argv.index("--rounds") + 1]))
    del models, x
    torch.cuda.empty_cache()
    launches.update(phase_xv_slices(torch, wrappers, profile_dir))
    torch.cuda.empty_cache()
    phase_audionet_small_reference(torch)
    launches.update(phase_audionet_slices(torch, wrappers, profile_dir))
    torch.cuda.empty_cache()
    launches.update(phase_cw2_slices(torch, wrappers, profile_dir))
    torch.cuda.empty_cache()
    nes_recs = phase_nes_kernels(torch, chol)
    launches.update(phase_fakebob_slices(torch, wrappers, profile_dir))
    torch.cuda.empty_cache()
    phase_defense_small_reference(torch)
    launches.update(phase_defended_slices(torch, wrappers, profile_dir))
    torch.cuda.empty_cache()
    adpcm_rec = phase_codec_small_reference(torch, clock_mhz)
    siren_recs = phase_siren_kernels(torch, chol)
    launches.update(phase_slice15(torch, wrappers))
    torch.cuda.empty_cache()
    launches.update(phase_train_slices(torch, wrappers, profile_dir))
    torch.cuda.empty_cache()
    cli_rec = phase_cli_kernels(torch, chol)
    launches.update(phase_cli(torch, wrappers))
    torch.cuda.empty_cache()
    launches.update(phase_train_clis(torch, wrappers))
    torch.cuda.empty_cache()
    launches.update(phase_dp_one_card(torch, profile_dir))

    chol_src = "speakerguard_tpu_torch/csrc/chol.cu"
    gmm_src = "speakerguard_tpu_torch/csrc/gmm.cu"
    # kernel: (source, the TPU kernel it replaces, the slice that is its
    # main path)
    where = {
        "cholesky_rt": (chol_src, "speakerguard_tpu/ops/pallas_chol.py:489",
                        "slice"),
        "cholesky_rt_dinv": (chol_src,
                             "speakerguard_tpu/ops/pallas_chol.py:251",
                             "slice_chol_dinv"),
        "chol_solve": (chol_src, "speakerguard_tpu/ops/pallas_chol.py:440",
                       "slice_chol_solve"),
        "fused_loglike": (gmm_src, "speakerguard_tpu/ops/pallas_gmm.py:61",
                          "slice_fast_kernels"),
        "stats_fwd": ("speakerguard_tpu_torch/csrc/gmm_stats_fwd.cu",
                      "speakerguard_tpu/ops/pallas_gmm_stats.py:179",
                      "slice_fast_kernels"),
        "stats_bwd": ("speakerguard_tpu_torch/csrc/gmm_stats_bwd.cu",
                      "speakerguard_tpu/ops/pallas_gmm_stats.py:226",
                      "slice_fast_kernels")}
    kernels = []
    for k, (src, replaces, path) in where.items():
        rec = recs[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[path][k],
            "launches_by_path": {p: v[k] for p, v in launches.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    for k in kernels:  # the Cholesky family: kernels per call, the sweep
        for key in ("device_kernels_per_call", "sweep_ms"):
            if key in recs[k["name"]]:
                k[key] = recs[k["name"]][key]
    ll = next(k for k in kernels if k["name"] == "fused_loglike")
    ll["bound_f32_simt_ms"] = recs["fused_loglike"]["bound_f32_simt_ms"]
    ll["launch_ms"] = {k: v["ms"] for k, v in loglike_launch_recs.items()
                       if "ms" in v}
    fwd = next(k for k in kernels if k["name"] == "stats_fwd")
    fwd["library_aligned_ms"] = recs["stats_fwd"]["library_aligned_ms"]
    fwd["launch_ms"] = {k: v["ms"] for k, v in launch_recs.items()
                        if "ms" in v}
    bwd = next(k for k in kernels if k["name"] == "stats_bwd")
    bwd["library_bwd_product_ms"] = recs["stats_bwd"][
        "library_bwd_product_ms"]
    bwd["launch_ms"] = {k: v["ms"] for k, v in bwd_launch_recs.items()
                        if "ms" in v}
    for k in kernels:  # the NES shape of slice_fakebob_osi_fast
        if k["name"] in nes_recs:
            r = nes_recs[k["name"]]
            k["nes_shape"] = {key: r[key] for key in (
                "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by")}
    for k in kernels:  # slice_defended_iv's shape (64 x 150 frames)
        if k["name"] in defended_recs:
            r = defended_recs[k["name"]]
            k["defended_shape"] = {key: r[key] for key in (
                "case", "B", "T", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
    for k in kernels:  # slice_siren_iv's shapes
        if k["name"] in siren_recs:
            r = siren_recs[k["name"]]
            k["siren_shape"] = {key: r[key] for key in (
                "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
            k["siren_shape"]["launches"] = launches["slice_siren_iv"][
                k["name"]]
    chol_k = next(k for k in kernels if k["name"] == "cholesky_rt")
    chol_k["cli_shape"] = {key: cli_rec[key] for key in (
        "case", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms")}
    chol_k["cli_shape"]["launches"] = launches["cli_iv"]["cholesky_rt"]
    fwd["siren_shape"]["launch_ms"] = {
        k: v["ms"] for k, v in siren_launch_recs.items() if "ms" in v}
    # the port's own kernel: no Pallas kernel stands behind it
    ad_bound, ad_by = _bound(adpcm_rec["bound_bytes_ms"],
                             adpcm_rec["bound_ops_ms"])
    kernels.append({
        "name": "adpcm", "route": "cuda",
        "source": "speakerguard_tpu_torch/csrc/adpcm.cu",
        "replaces": "speakerguard_tpu/defenses/speech_compression.py:200 "
                    "(a lax.scan; no Pallas kernel)",
        "pallas_counterpart": None,
        "launches": launches["slice_defended_adpcm_xv"]["adpcm"],
        "launches_by_path": {p: v["adpcm"] for p, v in launches.items()},
        "max_abs_err": adpcm_rec["max_abs_err"], "ms": adpcm_rec["ms"],
        "plain_ms": adpcm_rec["plain_ms"], "bound_ms": ad_bound,
        "bound_by": ad_by, "library_ms": None,
        "bound_chain_ms": adpcm_rec["bound_chain_ms"],
        "binds": adpcm_rec["binds"],
        "cycles_per_sample": adpcm_rec["cycles_per_sample"],
        "ms_512x4800": adpcm_rec["ms_512x4800"],
        "defense_ms": adpcm_rec["defense_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
