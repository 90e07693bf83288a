"""Native numpy PESQ (ITU-T P.862 structure, P.862.2 wideband mapping).

Port of speakerguard_tpu/metrics/pesq_native.py: a verbatim copy (numpy
and scipy only, on the host), since this package imports nothing of the JAX
package; tests/test_torch_metrics.py holds it to the goldens.

Replaces the compiled `pesq` package dependency (reference
metric/metric.py:44-48) for the adversarial-audio use case: reference and
degraded signals are the same utterance plus a small perturbation — equal
length, zero (or near-zero) delay, no transcoding time warps.

Implemented from the P.862 specification:

  * level alignment to a fixed internal power in the speech band
  * 100 Hz high-pass input filter (P.862.2 wideband input characteristic)
  * crude delay estimation by frame-energy cross-correlation
  * utterance splitting (active-speech sections >= 300 ms separated by
    >= 200 ms silences) with PER-UTTERANCE fine alignment: each
    utterance's delay is refined to the sample by restricted
    cross-correlation and the degraded signal is spliced accordingly, so
    material whose delay varies between utterances (codecs, VoIP) is
    scored on aligned audio (P.862 time-alignment structure)
  * bad-interval re-decoding (P.862 §10.2.5 structure): runs of
    consecutive frames whose symmetric disturbance exceeds a calibrated
    threshold are re-aligned by a restricted raw-signal correlation
    search and rescored; the smaller disturbance wins, so delay changes
    WITHIN an utterance (mid-stream codec slips) stop reading as
    catastrophic loudness error (constants at BAD_FRAME_THRESHOLD)
  * 32 ms Hann frames, 50% overlap, power spectra binned into 49 Bark
    bands (Schroeder scale, uniform in Bark over 0..8 kHz)
  * partial frequency-response compensation of the reference and
    short-term gain compensation of the degraded signal
  * Zwicker intensity->loudness with band-dependent exponent and absolute
    hearing threshold (Terhardt curve)
  * center-clipped (0.25 min) loudness-difference disturbance, asymmetric
    disturbance via the (deg/ref)^1.2 band-power ratio gated at [3, 12]
  * per-frame pseudo-Lp (p=2 symmetric / p=1 asymmetric) with Bark-width
    weights, low-reference-power frame emphasis, 45 cap
  * L6 over 20-frame "syllables" (step 10), L2 across syllables
  * raw = 4.5 - 0.1 d_symm - 0.0309 d_asym, mapped to MOS-LQO by the
    P.862.2 logistic y = 0.999 + 4/(1 + exp(-1.3669 x + 3.8224))

CALIBRATION (r4, replaces the r2 "re-fitted SP" note): the density scale is
structured as  ppd_b = sum_bins |X|^2 * corr_b * SP_16K * W_NORM  with the
PUBLISHED P.862 constants SP_16K = 6.910853e-6 and SL_16K = 1.866055e-1
verbatim, corr_b = width_hz_b / (bins_b * delta_f) the formula-derived
band-width correction, and ONE remaining normalization W_NORM relating our
FFT convention (unnormalized numpy rfft of a Hann-windowed 512 frame) to
the ITU's internal units.  Two candidate anchors for W_NORM were computed:

  1. The Zwicker sone definition (a 1 kHz tone at 40 dB SPL has loudness
     1 sone, with P.862's 79 dB SPL <-> 1e7 int16^2 internal convention and
     the Terhardt absolute threshold): solving Sl*(thr/0.5)^0.23 *
     ((0.5+0.5*R)^0.23 - 1) = 1 gives W_NORM = 9.33.
  2. The published P.862.2 behavioral characterization (speech+AWGN MOS
     curve: ~4.5 @ 40 dB SNR, ~3.3 @ 30, ~2.1 @ 20, ~1.5 @ 10):
     W_NORM = 0.3125.

These disagree by 30x, and (1) produces a wildly wrong MOS curve (2.6 @
40 dB SNR) — demonstrating that the ITU's FITTED per-band companion tables
(abs_thresh_power_16k, pow_dens_correction_factor_16k), which this offline
environment cannot obtain, deviate from the raw Terhardt/Zwicker formulas
and are load-bearing for absolute conformance.  W_NORM therefore uses the
behavioral anchor (2); the gated certification test
(tests/test_metric_golden.py) remains the path to true ITU conformance the
day the compiled package or the ITU tables are available.

Identical signals score the exact wideband ceiling 4.644 (raw 4.5 through
the P.862.2 map), scores degrade monotonically with perturbation size, and
an independently-written second implementation cross-checks every golden
value (tests/test_metric_golden.py::test_pesq_matches_independent...).
"""

import numpy as np
from scipy import signal as ssig

FS = 16000
FRAME = 512          # 32 ms
HOP = 256
NB = 49              # Bark bands (wideband)
DF = FS / FRAME      # 31.25 Hz FFT bin width
SP_16K = 6.910853e-6  # published P.862 power-density calibration (16 kHz)
SL_16K = 1.866055e-1  # published P.862 loudness calibration (16 kHz)
W_NORM = 0.3125       # FFT/band normalization (behavioral anchor; see
                      # module docstring for the derivation + the sone-
                      # anchor contradiction finding)
SL = SL_16K


def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _bark_inv(z):
    return 650.0 * np.sinh(np.asarray(z, np.float64) / 7.0)


class _Tables:
    """Per-band constants, built once."""

    def __init__(self):
        z_edges = np.linspace(_bark(0.0), _bark(FS / 2), NB + 1)
        self.width_bark = np.diff(z_edges)                      # (NB,)
        self.centre_bark = 0.5 * (z_edges[:-1] + z_edges[1:])
        f_edges = _bark_inv(z_edges)
        self.width_hz = np.diff(f_edges)
        centre_hz = 0.5 * (f_edges[:-1] + f_edges[1:])
        self.centre_hz = centre_hz

        # fft-bin -> band assignment (bin 0 = DC excluded from bands)
        freqs = np.arange(FRAME // 2 + 1) * (FS / FRAME)
        self.band_of_bin = np.clip(
            np.searchsorted(f_edges, freqs, side="right") - 1, 0, NB - 1)
        self.bins_per_band = np.maximum(
            np.bincount(self.band_of_bin[1:], minlength=NB), 1)

        # absolute hearing threshold (Terhardt 1979), dB SPL -> internal
        # power units.  Internal calibration: active speech is levelled to
        # 1e7 power =~ 79 dB SPL, so 0 dB SPL =~ 10^(7 - 7.9) power units.
        khz = np.clip(centre_hz, 20.0, None) / 1000.0
        thr_db = (3.64 * khz ** -0.8
                  - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
                  + 1e-3 * khz ** 4)
        thr_db = np.clip(thr_db, -10.0, 90.0)
        self.abs_thresh = 10.0 ** ((thr_db - 9.0) / 10.0)

        # band-dependent Zwicker exponent modifier (P.862: low bands get
        # h = 6/(z+2) capped at 2, compressed by ^0.15)
        h = np.where(self.centre_bark < 4.0,
                     6.0 / (self.centre_bark + 2.0), 1.0)
        h = np.minimum(h, 2.0) ** 0.15
        self.zwicker_exp = 0.23 * h


_T = _Tables()


def _level_align(x):
    """Scale so mean power over the 350-3250 Hz band of the active part is
    the internal target 1e7 (P.862 fixed level alignment)."""
    spec = np.fft.rfft(x)
    freqs = np.arange(len(spec)) * (FS / len(x))
    band = (freqs >= 350.0) & (freqs <= 3250.0)
    band_power = (np.abs(spec[band]) ** 2).sum() / len(x) ** 2 * 2.0
    active = max(np.mean(x ** 2), 1e-20)
    # power of the in-band signal per sample
    p = max(band_power, 1e-6 * active, 1e-20)
    return x * np.sqrt(1.0e7 / p)


def _input_filter(x):
    """P.862.2 wideband input characteristic: 100 Hz high-pass."""
    sos = ssig.butter(4, 100.0 / (FS / 2), "highpass", output="sos")
    return ssig.sosfilt(sos, x)


def _crude_align(ref, deg):
    """Integer-sample delay of deg relative to ref via cross-correlation of
    4 ms frame-energy envelopes; shift deg to align (zero-pad)."""
    flen = 64
    n = min(len(ref), len(deg)) // flen * flen
    er = (ref[:n].reshape(-1, flen) ** 2).sum(1)
    ed = (deg[:n].reshape(-1, flen) ** 2).sum(1)
    er = np.log1p(er)
    ed = np.log1p(ed)
    corr = ssig.correlate(ed - ed.mean(), er - er.mean(), mode="full")
    delay_frames = int(np.argmax(corr)) - (len(er) - 1)
    delay = delay_frames * flen
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        deg = np.concatenate([np.zeros(-delay), deg])
    m = min(len(ref), len(deg))
    return ref[:m], deg[:m]


def _split_utterances(ref):
    """Utterance boundaries on the (level-aligned, filtered) reference:
    16 ms frame log-energies, active within 40 dB of the peak; active runs
    joined across gaps < 200 ms, kept if >= 300 ms, with boundaries pushed
    to the midpoints of the flanking silences (P.862 utterance structure).
    Returns [(start_sample, end_sample)]; whole signal if nothing found."""
    flen = 256  # 16 ms
    n = len(ref) // flen
    if n < 2:
        return [(0, len(ref))]
    e = (ref[: n * flen].reshape(n, flen) ** 2).sum(1)
    edb = 10.0 * np.log10(e + 1e-12)
    act = edb > edb.max() - 40.0
    # active runs in frame units
    runs = []
    i = 0
    while i < n:
        if act[i]:
            j = i
            while j < n and act[j]:
                j += 1
            runs.append([i, j])
            i = j
        else:
            i += 1
    if not runs:
        return [(0, len(ref))]
    # join across silences < 200 ms (12 frames)
    joined = [runs[0]]
    for s, t in runs[1:]:
        if s - joined[-1][1] < 12:
            joined[-1][1] = t
        else:
            joined.append([s, t])
    # keep utterances >= 300 ms (19 frames); if none survive, keep longest
    kept = [r for r in joined if r[1] - r[0] >= 19] or \
        [max(joined, key=lambda r: r[1] - r[0])]
    # extend boundaries to silence midpoints
    utts = []
    for k, (s, t) in enumerate(kept):
        lo = 0 if k == 0 else (kept[k - 1][1] + s) // 2
        hi = n if k == len(kept) - 1 else (t + kept[k + 1][0]) // 2
        utts.append((lo * flen, min(hi * flen, len(ref))))
    return utts


def _utterance_delay(ref_seg, deg, s, e, max_delay):
    """Delay of deg relative to ref over one utterance: crude (4 ms
    energy-envelope correlation over +-max_delay) then fine (sample-level
    cross-correlation within +-96 samples of the crude estimate)."""
    flen = 64
    lo = max(0, s - max_delay)
    hi = min(len(deg), e + max_delay)
    deg_win = deg[lo:hi]
    nr = len(ref_seg) // flen
    nd = len(deg_win) // flen
    if nr < 2 or nd < 2:
        return 0
    er = np.log1p((ref_seg[: nr * flen].reshape(nr, flen) ** 2).sum(1))
    ed = np.log1p((deg_win[: nd * flen].reshape(nd, flen) ** 2).sum(1))
    corr = ssig.correlate(ed - ed.mean(), er - er.mean(), mode="full")
    crude = (int(np.argmax(corr)) - (nr - 1)) * flen + lo - s
    # fine: +-96 samples around the crude delay
    fine_span = 96
    best_d, best_c = crude, -np.inf
    a = ref_seg - ref_seg.mean()
    na = np.linalg.norm(a) + 1e-12
    lags = np.arange(crude - fine_span, crude + fine_span + 1)
    for d in lags:
        ds, de = s + d, e + d
        if ds < 0 or de > len(deg):
            continue
        b = deg[ds:de]
        c = float(a @ (b - b.mean())) / na
        if c > best_c:
            best_c, best_d = c, int(d)
    return best_d


def _utterance_align(ref, deg, max_delay=FS // 4):
    """Per-utterance fine alignment: splice the degraded signal so each
    reference utterance lines up with its delayed counterpart (delay may
    differ between utterances).  Zero-delay pairs are returned unchanged
    (bit-identical scores for perturbation-style degradations)."""
    n = len(ref)
    aligned = np.zeros(n)
    m = min(n, len(deg))
    aligned[:m] = deg[:m]
    for s, e in _split_utterances(ref):
        d = _utterance_delay(ref[s:e], deg, s, e, max_delay)
        if d == 0:
            continue
        seg = np.zeros(e - s)
        ds, de = s + d, e + d
        src_lo, src_hi = max(ds, 0), min(de, len(deg))
        if src_hi > src_lo:
            seg[src_lo - ds: src_hi - ds] = deg[src_lo:src_hi]
        aligned[s:e] = seg
    return aligned


def _pitch_power_densities(x):
    """(T, NB) Bark-band power densities of 32 ms Hann frames."""
    n_frames = (len(x) - FRAME) // HOP + 1
    if n_frames <= 0:
        return np.zeros((0, NB))
    idx = (np.arange(n_frames) * HOP)[:, None] + np.arange(FRAME)[None, :]
    w = np.hanning(FRAME)
    spec = np.fft.rfft(x[idx] * w, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2)
    power[:, 0] = 0.0  # exclude DC
    bands = np.zeros((n_frames, NB))
    np.add.at(bands.T, _T.band_of_bin, power.T)
    # sum_bins |X|^2 * corr_b * Sp * W: width_hz/(bins*DF) is the
    # formula-derived band correction, SP_16K the published constant,
    # W_NORM the documented FFT normalization (module docstring)
    return (bands / _T.bins_per_band * _T.width_hz
            * (SP_16K * W_NORM / DF))


def _loudness(ppd):
    """Zwicker intensity -> loudness, (T, NB) -> (T, NB)."""
    p0 = _T.abs_thresh[None, :]
    g = _T.zwicker_exp[None, :]
    loud = (SL * (p0 / 0.5) ** g
            * ((0.5 + 0.5 * ppd / p0) ** g - 1.0))
    return np.where(ppd > p0, loud, 0.0)


def _pseudo_lp(d, p):
    """P.862 pseudo-Lp over bands with Bark-width weights, (T, NB)->(T,)."""
    w = _T.width_bark[None, :]
    tot = _T.width_bark.sum()
    return (np.sum((np.abs(d) * w) ** p, axis=1) / tot) ** (1.0 / p) * tot


def _lpq_time(frame_d, p_syll=6.0, p_time=2.0, syll=20, step=10):
    """L6 over 20-frame syllables (step 10), then L2 over syllables."""
    t = len(frame_d)
    if t == 0:
        return 0.0
    vals = []
    for s in range(0, max(t - syll, 0) + 1, step):
        seg = frame_d[s:s + syll]
        vals.append((np.mean(seg ** p_syll)) ** (1.0 / p_syll))
    if not vals:
        vals = [(np.mean(frame_d ** p_syll)) ** (1.0 / p_syll)]
    v = np.asarray(vals)
    return float((np.mean(v ** p_time)) ** (1.0 / p_time))


def _frame_disturbances(ppd_ref, ppd_deg):
    """(T, NB) reference/degraded pitch-power densities -> per-frame
    symmetric and asymmetric disturbances (T,) each, via partial
    frequency-response compensation, short-term gain compensation,
    Zwicker loudness, center-clipped + asymmetric disturbance, pseudo-Lp
    with low-reference-power emphasis and the 45 cap."""
    t = len(ppd_ref)
    frame_pow_ref = ppd_ref.sum(1)
    frame_pow_deg = ppd_deg.sum(1)
    active = frame_pow_ref > 1e4  # speech-active frames
    if not active.any():
        active = np.ones(t, bool)

    # partial frequency-response compensation (applied to the reference)
    mean_ref = ppd_ref[active].mean(0)
    mean_deg = ppd_deg[active].mean(0)
    band_ratio = np.clip((mean_deg + 1000.0) / (mean_ref + 1000.0),
                         0.01, 100.0)
    ppd_ref_eq = ppd_ref * band_ratio[None, :]

    # short-term gain compensation (applied to the degraded signal)
    raw_gain = ((frame_pow_ref + 5e3) / (frame_pow_deg + 5e3))
    gain = np.empty_like(raw_gain)
    h = 1.0
    for i in range(t):
        h = 0.8 * h + 0.2 * raw_gain[i]
        gain[i] = np.clip(h, 3e-4, 5.0)
    ppd_deg_eq = ppd_deg * gain[:, None]

    loud_ref = _loudness(ppd_ref_eq)
    loud_deg = _loudness(ppd_deg_eq)

    # center-clipped disturbance
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetric disturbance
    r = ((ppd_deg_eq + 50.0) / (ppd_ref_eq + 50.0)) ** 1.2
    r = np.where(r < 3.0, 0.0, np.minimum(r, 12.0))
    da = d * r

    frame_d = _pseudo_lp(d, 2.0)
    frame_da = _pseudo_lp(da, 1.0)

    # emphasize low-reference-power frames, cap at 45
    emph = ((frame_pow_ref + 1e5) / 1e7) ** 0.04
    frame_d = np.minimum(frame_d / emph, 45.0)
    frame_da = np.minimum(frame_da / emph, 45.0)
    return frame_d, frame_da


# bad-interval re-decoding constants (P.862 §10.2.5 structure: frames
# whose symmetric disturbance exceeds the threshold form intervals; each
# interval's delay is re-searched and the interval is rescored on the
# re-decoded audio, keeping whichever disturbance is smaller).  The ITU
# uses threshold 30 / 5 frames on ITS disturbance scale; this
# implementation's scale sits lower (W_NORM calibration, module
# docstring), with a measured ~5 noise floor on perturbation-style pairs
# and 15-45 on genuinely misaligned speech, so the trigger is calibrated
# to 10 / 3.  Zero-delay pairs are structurally unaffected regardless:
# their interval correlation peaks at d=0, which skips rescoring.
BAD_FRAME_THRESHOLD = 10.0
MIN_BAD_FRAMES = 3
BAD_SEARCH = 2 * FRAME  # +- sample search span per interval


def _bad_intervals(frame_d):
    """Runs of >= MIN_BAD_FRAMES consecutive frames whose symmetric
    disturbance exceeds BAD_FRAME_THRESHOLD -> [(start_frame, end_frame)]."""
    bad = frame_d > BAD_FRAME_THRESHOLD
    out = []
    i, t = 0, len(bad)
    while i < t:
        if bad[i]:
            j = i
            while j < t and bad[j]:
                j += 1
            if j - i >= MIN_BAD_FRAMES:
                out.append((i, j))
            i = j
        else:
            i += 1
    return out


def _interval_delay(ref, deg, s_smp, e_smp):
    """Sample-level delay of deg vs ref over one bad interval, found by
    raw cross-correlation restricted to +-BAD_SEARCH (the P.862 interval
    realignment search)."""
    a = ref[s_smp:e_smp]
    na = np.linalg.norm(a) + 1e-12
    best_d, best_c = 0, -np.inf
    for d in range(-BAD_SEARCH, BAD_SEARCH + 1, 8):  # coarse (8-sample)
        ds, de = s_smp + d, e_smp + d
        if ds < 0 or de > len(deg):
            continue
        c = float(a @ deg[ds:de]) / na
        if c > best_c:
            best_c, best_d = c, d
    # fine pass +-8 around the coarse winner
    for d in range(best_d - 8, best_d + 9):
        ds, de = s_smp + d, e_smp + d
        if d == best_d or ds < 0 or de > len(deg):
            continue
        c = float(a @ deg[ds:de]) / na
        if c > best_c:
            best_c, best_d = c, d
    return best_d


def _redecode_bad_intervals(ref, deg, ppd_ref, ppd_deg, frame_d, frame_da):
    """P.862 bad-interval loop: for each interval of consecutive
    high-disturbance frames, re-search the interval's delay against the
    raw signals, recompute the interval's degraded power densities on the
    re-aligned audio, rescore, and keep the smaller disturbance (the
    original scoring stands where realignment doesn't help)."""
    intervals = _bad_intervals(frame_d)
    if not intervals:
        return frame_d, frame_da
    w = np.hanning(FRAME)
    for fs, fe in intervals:
        s_smp = fs * HOP
        e_smp = min((fe - 1) * HOP + FRAME, len(ref), len(deg))
        d = _interval_delay(ref, deg, s_smp, e_smp)
        if d == 0:
            continue
        ppd_alt = ppd_deg.copy()
        redone = []
        for i in range(fs, fe):
            lo = i * HOP + d
            if lo < 0 or lo + FRAME > len(deg):
                continue
            spec = np.fft.rfft(deg[lo:lo + FRAME] * w)
            power = spec.real ** 2 + spec.imag ** 2
            power[0] = 0.0
            bands = np.bincount(_T.band_of_bin, weights=power,
                                minlength=NB)
            ppd_alt[i] = (bands / _T.bins_per_band * _T.width_hz
                          * (SP_16K * W_NORM / DF))
            redone.append(i)
        if not redone:
            continue
        alt_d, alt_da = _frame_disturbances(ppd_ref, ppd_alt)
        # joint per-interval decision on the symmetric disturbance
        if alt_d[fs:fe].sum() < frame_d[fs:fe].sum():
            frame_d = frame_d.copy()
            frame_da = frame_da.copy()
            frame_d[fs:fe] = alt_d[fs:fe]
            frame_da[fs:fe] = alt_da[fs:fe]
    return frame_d, frame_da


def pesq_wb(ref, deg, bad_interval_redecode=True):
    """Wideband PESQ MOS-LQO for 16 kHz float signals in [-1, 1).

    Follows the P.862 perceptual model + P.862.2 output mapping (see module
    docstring for conformance caveats).  bad_interval_redecode=False skips
    the bad-interval realignment loop (exposed for tests; the loop is a
    no-op when no frame's disturbance crosses BAD_FRAME_THRESHOLD, so
    perturbation-style zero-delay pairs score identically either way)."""
    ref = np.asarray(ref, np.float64).flatten() * 32768.0
    deg = np.asarray(deg, np.float64).flatten() * 32768.0
    if len(ref) < 2 * FRAME or len(deg) < 2 * FRAME:
        raise ValueError("signals too short for PESQ (need >= 64 ms)")

    ref = _input_filter(_level_align(ref))
    deg = _input_filter(_level_align(deg))
    ref, deg = _crude_align(ref, deg)
    deg = _utterance_align(ref, deg)

    ppd_ref = _pitch_power_densities(ref)
    ppd_deg = _pitch_power_densities(deg)
    t = min(len(ppd_ref), len(ppd_deg))
    if t == 0:
        raise ValueError("no frames")
    ppd_ref, ppd_deg = ppd_ref[:t], ppd_deg[:t]

    frame_d, frame_da = _frame_disturbances(ppd_ref, ppd_deg)
    if bad_interval_redecode:
        frame_d, frame_da = _redecode_bad_intervals(
            ref, deg, ppd_ref, ppd_deg, frame_d, frame_da)

    d_symm = _lpq_time(frame_d)
    d_asym = _lpq_time(frame_da)

    raw = 4.5 - 0.1 * d_symm - 0.0309 * d_asym
    # P.862.2 wideband mapping to MOS-LQO
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
