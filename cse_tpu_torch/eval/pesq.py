"""PESQ (ITU-T P.862, narrowband 8 kHz) — host-side float64 reimplementation.

The port's copy of ``cse_tpu/eval/pesq.py`` (the same numpy code).

The north-star metric set names PESQ next to SI-SDRi (BASELINE.json: "match
reference SI-SDRi/PESQ"); the reference code itself never computes it
(reference ``test.py:198-201`` reports SI-SNR/SDR only), so this module
adds the missing column to the eval protocol.

This is a from-the-spec reimplementation of the P.862 narrowband perceptual
model: level alignment to a fixed active-band power over the spec's
350-3250 Hz band, the standard IRS-receive band-pass (the spec's TABULATED
dB response, ``_IRS_RECEIVE_DB`` below), utterance-split time alignment
(whole-signal crude+fine first, then a per-utterance fine refinement, the
spec's alignment structure), 32 ms Hann frames -> Bark-band pitch powers,
partial frequency- and gain-compensation, Zwicker-law loudness,
center-clipped symmetric + asymmetric disturbances, L6-over-frames /
L2-over-splits aggregation and the published score map
PESQ = 4.5 - 0.1*D - 0.0309*DA (plus the P.862.1 MOS-LQO mapping).

VALIDATION CAVEAT (documented deliberately): the ITU conformance vectors and
the reference C implementation are not available in this zero-egress image,
so this implementation is validated by the model's structural properties
(identity -> 4.5; strict monotonicity under decreasing SNR; invariance to
level offsets and to alignable delays, including utterance-dependent ones;
known degradations rank correctly) rather than by bit-exact comparison — see
``tests/test_pesq.py``, whose conformance test AUTO-ACTIVATES when the ITU
reference becomes available (pip ``pesq`` or ``CSE_PESQ_VECTORS``). Items
still approximated rather than transcribed, because the spec publishes them
only as reference-code tables whose ~250 values cannot be reproduced from
the prose: the 49-band Bark partition (here: 42 bands uniform in Zwicker
Bark over 100-4000 Hz) and the per-band absolute-threshold powers (here: the
ISO 389-7 analytic threshold curve). Scores are therefore "P.862-scale",
suitable for relative comparisons across systems evaluated by THIS
framework, and the result files label the column ``pesq_p862`` to keep that
provenance visible.
"""

from __future__ import annotations

import numpy as np

_SR = 8000
_FRAME = 256  # 32 ms
_HOP = 128  # 50% overlap
_NBARK = 42  # narrowband Bark resolution
_TARGET_POWER = 1e7  # active-band alignment level
_ZWICKER_POWER = 0.23
_ABS_THRESH_SCALE = 1e4


def _bark(f: np.ndarray) -> np.ndarray:
    """Zwicker's critical-band rate (traditional analytic form)."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _band_edges() -> np.ndarray:
    """42 bands uniform in Bark over the 100-4000 Hz NB band, in Hz."""
    z = np.linspace(_bark(100.0), _bark(4000.0), _NBARK + 1)
    # invert bark numerically (monotone)
    fs = np.linspace(0.0, 4000.0, 4001)
    return np.interp(z, _bark(fs), fs)


_EDGES = _band_edges()
_CENTERS = 0.5 * (_EDGES[:-1] + _EDGES[1:])
_WIDTHS_BARK = np.diff(_bark(_EDGES))

# absolute hearing threshold (dB SPL, ISO 389-7 analytic approximation) at
# the band centers, converted to the internal power scale
_THR_DB = (
    3.64 * (_CENTERS / 1000.0) ** -0.8
    - 6.5 * np.exp(-0.6 * (_CENTERS / 1000.0 - 3.3) ** 2)
    + 1e-3 * (_CENTERS / 1000.0) ** 4
)
_ABS_THRESH = _ABS_THRESH_SCALE * 10.0 ** (np.clip(_THR_DB, -20, 60) / 10.0)


# The standard (full) IRS receive characteristic applied by P.862's
# narrowband mode before the perceptual model, as TABULATED in the spec's
# reference implementation (``standard_IRS_filter_dB``): (Hz, dB) points,
# piecewise-linearly interpolated in dB over frequency. -200 dB entries are
# the stop band.
_IRS_RECEIVE_DB = np.array([
    [0.0, -200.0], [50.0, -40.0], [100.0, -20.0], [125.0, -12.0],
    [160.0, -6.0], [200.0, 0.0], [250.0, 4.0], [300.0, 6.0], [350.0, 8.0],
    [400.0, 10.0], [500.0, 11.0], [600.0, 12.0], [700.0, 12.0],
    [800.0, 12.0], [1000.0, 12.0], [1300.0, 12.0], [1600.0, 12.0],
    [2000.0, 12.0], [2500.0, 12.0], [3000.0, 12.0], [3250.0, 12.0],
    [3500.0, 4.0], [4000.0, -200.0], [5000.0, -200.0], [6300.0, -200.0],
    [8000.0, -200.0],
])


def _irs_weight(f: np.ndarray) -> np.ndarray:
    """Standard IRS-receive band-pass magnitude from the spec's tabulated dB
    response (interpolated in dB, converted to linear magnitude). The +12 dB
    passband plateau is a common gain the level alignment removes; what
    matters perceptually is the RELATIVE shaping across bands."""
    f = np.asarray(f, np.float64)
    db = np.interp(f, _IRS_RECEIVE_DB[:, 0], _IRS_RECEIVE_DB[:, 1])
    return 10.0 ** (db / 20.0)


def _frames(x: np.ndarray) -> np.ndarray:
    n = 1 + max(0, (len(x) - _FRAME)) // _HOP
    idx = np.arange(_FRAME)[None, :] + _HOP * np.arange(n)[:, None]
    return x[idx]


_WINDOW = np.hanning(_FRAME + 1)[:-1]
_FFT_FREQS = np.fft.rfftfreq(_FRAME, d=1.0 / _SR)
_IRS = _irs_weight(_FFT_FREQS)
# FFT-bin -> Bark-band pooling matrix [nbins, NBARK] (mean within band)
_POOL = np.zeros((_FFT_FREQS.size, _NBARK))
for _b in range(_NBARK):
    _sel = (_FFT_FREQS >= _EDGES[_b]) & (_FFT_FREQS < _EDGES[_b + 1])
    if not _sel.any():  # narrow low bands: take the nearest bin
        _sel = np.zeros_like(_sel)
        _sel[np.argmin(np.abs(_FFT_FREQS - _CENTERS[_b]))] = True
    _POOL[_sel, _b] = 1.0 / _sel.sum()


def _level_align(x: np.ndarray) -> np.ndarray:
    """Scale to a fixed power over the spec's 350-3250 Hz alignment band
    (the P.862 level alignment's band-limited power estimate)."""
    spec = np.fft.rfft(np.pad(x, (0, (-len(x)) % _FRAME)).reshape(-1, _FRAME))
    band = (_FFT_FREQS >= 350) & (_FFT_FREQS <= 3250)
    p = np.mean(np.abs(spec[:, band]) ** 2) / _FRAME + 1e-12
    return x * np.sqrt(_TARGET_POWER / p)


def _align_delay(ref: np.ndarray, deg: np.ndarray, max_ms: float = 125.0) -> int:
    """Envelope cross-correlation delay estimate (samples; deg relative to
    ref), the crude stage of the P.862 time alignment. The framework's own
    eval signals are aligned by construction, so this mainly guards against
    externally produced files."""
    fr = _frames(ref)
    fd = _frames(deg)
    n = min(len(fr), len(fd))
    if n < 4:
        return 0
    er = np.log10(1e-6 + np.sum(fr[:n] ** 2, axis=1))
    ed = np.log10(1e-6 + np.sum(fd[:n] ** 2, axis=1))
    er -= er.mean()
    ed -= ed.mean()
    max_lag = max(1, int(max_ms / 1000.0 * _SR / _HOP))
    lags = np.arange(-max_lag, max_lag + 1)
    cc = [
        np.sum(er[max(0, -l) : n - max(0, l)] * ed[max(0, l) : n - max(0, -l)])
        for l in lags
    ]
    frame_lag = int(lags[int(np.argmax(cc))])
    # fine stage: sample-resolution cross-correlation around the frame lag
    center = frame_lag * _HOP
    span = _HOP
    best, best_v = center, -np.inf
    seg = slice(0, min(len(ref), len(deg), 4 * _SR))
    r = ref[seg]
    for s in range(center - span, center + span + 1, 4):
        if s >= 0:
            d = deg[s : s + len(r)]
        else:
            d = np.pad(deg[: len(r) + s], (-s, 0))
        m = min(len(r), len(d))
        if m < _FRAME:
            continue
        v = float(np.dot(r[:m], d[:m]))
        if v > best_v:
            best_v, best = v, s
    return best


def _utterances(x: np.ndarray, join_ms: float = 200.0,
                min_ms: float = 64.0) -> list:
    """Speech-active sections of the reference, in samples — the spec's
    utterance splitting stage. Frame energies 35 dB below the active peak
    are silence; active runs separated by gaps shorter than ``join_ms`` are
    one utterance; runs shorter than ``min_ms`` are dropped."""
    fr = _frames(x)
    if len(fr) < 2:
        return [(0, len(x))]
    e = np.sum(fr**2, axis=1)
    act = e > e.max() * 10.0 ** (-35.0 / 10.0)
    # close short gaps
    gap = max(1, int(join_ms / 1000.0 * _SR / _HOP))
    idx = np.flatnonzero(act)
    if idx.size == 0:
        return [(0, len(x))]
    utts = []
    start = prev = idx[0]
    for i in idx[1:]:
        if i - prev > gap:
            utts.append((start, prev))
            start = i
        prev = i
    utts.append((start, prev))
    min_fr = max(1, int(min_ms / 1000.0 * _SR / _HOP))
    out = [
        (s * _HOP, min(len(x), (t + 1) * _HOP + _FRAME))
        for s, t in utts
        if t - s + 1 >= min_fr
    ]
    return out or [(0, len(x))]


def _align_utterances(ref: np.ndarray, deg: np.ndarray,
                      max_ms: float = 62.5) -> np.ndarray:
    """Per-utterance fine alignment (the spec's utterance-split stage, run
    AFTER the whole-signal crude+fine alignment in ``pesq_nb``): each
    speech-active section of the reference gets its own residual delay by
    sample-resolution cross-correlation, and — like the spec's recursive
    utterance splitting — a section is split in half whenever its two halves
    align materially better at DIFFERENT delays (a delay change inside one
    utterance, e.g. a VAD-gated or packet-loss-concealed path). The degraded
    signal is rebuilt with every aligned piece shifted into place."""
    out = deg.copy()
    max_lag = int(max_ms / 1000.0 * _SR)
    n = min(len(ref), len(deg))
    # zero-pad once so every lag in [-max_lag, max_lag] is addressable even
    # for utterances touching either signal boundary
    pad = max_lag + _HOP
    pdeg = np.pad(deg, (pad, pad))

    def best_lag(s, e):
        r = ref[s:e]
        if len(r) < 2 * _FRAME:
            return 0, 0.0
        # sample-resolution waveform correlation over the FULL residual
        # range. (An earlier hop-grid envelope "crude" stage mislocked on
        # flat-envelope content: its frame grid is offset from the reference
        # grid by max_lag % hop, which decorrelates noise-like envelopes at
        # EVERY grid point, and the fine stage could not escape its ±1-hop
        # window — shifting an IDENTICAL pair by hundreds of samples.)
        seg = pdeg[s - max_lag + pad : e + max_lag + pad]
        cc = np.correlate(seg, r, mode="valid")  # lag index j -> j - max_lag
        j = int(np.argmax(cc))
        top = float(cc[j])
        if top <= 0.0:
            return 0, 0.0
        # near-ties (within 1%) resolve toward the smallest |lag|: strongly
        # tonal content has correlation peaks a pitch period apart, and the
        # whole-signal alignment already removed the bulk delay, so the
        # smallest residual consistent with the evidence is the right pick
        near = np.flatnonzero(cc >= 0.99 * top)
        j = int(near[np.argmin(np.abs(near - max_lag))])
        return j - max_lag, float(cc[j])

    def shift_into(s, e, d):
        if d != 0:
            out[s:e] = pdeg[s + d + pad : e + d + pad]

    def align(s, e, depth=0):
        d, c = best_lag(s, e)
        if depth < 4 and e - s >= 8 * _FRAME:
            m = (s + e) // 2
            d1, c1 = best_lag(s, m)
            d2, c2 = best_lag(m, e)
            if d1 != d2 and c1 + c2 > 1.01 * c:
                align(s, m, depth + 1)
                align(m, e, depth + 1)
                return
        shift_into(s, e, d)

    for s, e in _utterances(ref[:n]):
        align(s, e)
    return out


def _bark_powers(x: np.ndarray) -> np.ndarray:
    """[T] -> pitch powers [frames, NBARK] after IRS weighting."""
    fr = _frames(x) * _WINDOW[None, :]
    spec = np.abs(np.fft.rfft(fr, axis=1)) ** 2 * (_IRS[None, :] ** 2)
    return spec @ _POOL


def _loudness(p: np.ndarray) -> np.ndarray:
    """Zwicker-law intensity -> loudness per band (Sone-like)."""
    t = _ABS_THRESH[None, :]
    s = (t / 0.5) ** _ZWICKER_POWER * (
        (0.5 + 0.5 * p / t) ** _ZWICKER_POWER - 1.0
    )
    return np.where(p > t, s, 0.0) * _WIDTHS_BARK[None, :]


def pesq_nb(ref: np.ndarray, deg: np.ndarray, sr: int = _SR) -> float:
    """P.862-scale narrowband score for deg against ref (raw, ~[-0.5, 4.5])."""
    if sr != _SR:
        raise ValueError(f"pesq_nb is the 8 kHz narrowband model, got sr={sr}")
    ref = np.asarray(ref, np.float64).ravel()
    deg = np.asarray(deg, np.float64).ravel()
    if min(len(ref), len(deg)) < 4 * _FRAME:
        raise ValueError("signals too short for PESQ (need >= 128 ms)")

    ref = _level_align(ref)
    deg = _level_align(deg)
    shift = _align_delay(ref, deg)
    if shift > 0:
        deg = deg[shift:]
    elif shift < 0:
        deg = np.pad(deg, (-shift, 0))
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    # the spec's utterance-split stage: per-utterance residual delays on top
    # of the global crude+fine alignment above
    deg = _align_utterances(ref, deg)

    pr = _bark_powers(ref)
    pd = _bark_powers(deg)
    nf = min(len(pr), len(pd))
    pr, pd = pr[:nf], pd[:nf]

    # partial frequency compensation: equalize deg by the per-band mean
    # ratio over speech-active frames, bounded to +-20 dB
    active = np.sum(pr, axis=1) > 1e2 * _ABS_THRESH.mean()
    if active.sum() >= 2:
        num = np.mean(pr[active], axis=0) + 1e3
        den = np.mean(pd[active], axis=0) + 1e3
        eq = np.clip(num / den, 1e-2, 1e2)
    else:
        eq = np.ones(_NBARK)
    pd = pd * eq[None, :]

    # partial gain compensation per frame (bounded), tracking slow AGC
    fr_num = np.sum(pr * _WIDTHS_BARK[None, :], axis=1) + 5e3
    fr_den = np.sum(pd * _WIDTHS_BARK[None, :], axis=1) + 5e3
    g = np.clip(fr_num / fr_den, 3e-4, 5.0)
    # first-order smoothing (the spec's recursive gain track)
    for i in range(1, nf):
        g[i] = 0.8 * g[i - 1] + 0.2 * g[i]
    pd = pd * g[:, None]

    lr = _loudness(pr)
    ld = _loudness(pd)

    # center-clipped symmetric disturbance
    diff = ld - lr
    dead = 0.25 * np.minimum(ld, lr)
    d = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry factor: added distortions weigh more than removed ones
    ratio = ((pd + 50.0) / (pr + 50.0)) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))

    w = _WIDTHS_BARK[None, :]
    frame_d = np.sqrt(np.sum(w * d**2, axis=1) / np.sum(w))
    frame_da = np.sum(w * np.abs(d) * asym, axis=1) / np.sum(w)

    # emphasize frames with speech energy (silent frames weigh less)
    e = np.sum(pr, axis=1)
    wf = ((e + 1e5) / 1e7) ** 0.04
    wf = np.clip(wf, 0.3, 2.0)
    frame_d = np.minimum(frame_d / wf, 45.0)
    frame_da = np.minimum(frame_da / wf, 45.0)

    def _agg(fd: np.ndarray) -> float:
        # L6 within ~20-frame splits, L2 across splits (the P.862 psc/pss)
        ns = max(1, len(fd) // 20)
        splits = np.array_split(fd, ns)
        l6 = np.array([np.mean(s**6.0) ** (1.0 / 6.0) for s in splits])
        return float(np.sqrt(np.mean(l6**2)))

    d_ind = _agg(frame_d)
    da_ind = _agg(frame_da)
    return float(np.clip(4.5 - 0.1 * d_ind - 0.0309 * da_ind, -0.5, 4.5))


def mos_lqo(pesq_raw: float) -> float:
    """P.862.1 mapping from the raw P.862 score to MOS-LQO."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * pesq_raw + 4.6607))


class PesqMetric:
    """Streaming mean of per-utterance P.862-scale scores (batch rows).

    ``sr`` is the rate of the signals fed to ``update``; the narrowband
    model runs at 8 kHz, so higher-rate inputs are polyphase-resampled to
    8 kHz first — passing e.g. 16 kHz samples straight into the 8 kHz model
    would silently halve every frame/band constant. Rates below 8 kHz are
    rejected (upsampling cannot restore the 0-4 kHz band P.862 scores)."""

    def __init__(self, sr: int = _SR):
        if int(sr) != sr or sr < _SR:
            raise ValueError(f"PesqMetric needs an integer rate >= 8 kHz, got {sr}")
        self.sr = int(sr)
        self.total = 0.0
        self.count = 0

    def update(self, enhanced: np.ndarray, gt: np.ndarray, lengths=None) -> None:
        enhanced = np.atleast_2d(np.asarray(enhanced, np.float64))
        gt = np.atleast_2d(np.asarray(gt, np.float64))
        for k, (e, g) in enumerate(zip(enhanced, gt)):
            if lengths is not None:
                n = int(lengths[k])
                e, g = e[:n], g[:n]
            if self.sr != _SR:
                import math as _math

                from scipy.signal import resample_poly

                d = _math.gcd(_SR, self.sr)
                e = resample_poly(e, _SR // d, self.sr // d)
                g = resample_poly(g, _SR // d, self.sr // d)
            try:
                self.total += pesq_nb(g, e)
            except ValueError:
                continue  # too-short rows don't poison the mean
            self.count += 1

    def compute(self) -> float:
        # nan, not 0.0: every row skipped (too short) must read as "nothing
        # measured" in the results file, not as a rock-bottom score
        return self.total / self.count if self.count else float("nan")
