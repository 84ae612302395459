"""BSS Eval v3 source metrics: SDR / SIR / SAR with the optimal permutation.

The port's own copy of `bss_eval_sources` of
`dnn_based_source_separation_tpu/utils/bss.py` (:21-122), bit for bit: the
reference's `src/utils/bss.py:4-30` wraps `mir_eval.separation.bss_eval_sources`,
re-implemented there from the BSS Eval v3 definition (Vincent et al., 2006).
The estimate is decomposed by least-squares projections onto 512-tap delayed
versions of the true source (s_true) and of all sources (s_true + e_interf);
the remainder is e_artif. Host-side numpy and scipy; the FFT-based Toeplitz
Gram assembly keeps it fast. Also `bss_eval_v4` (:125-222), museval's
images variant with global 512-tap filters and framewise SDR / ISR / SIR /
SAR, with its helpers, bit for bit.
"""
from __future__ import annotations

import itertools

import numpy as np
from scipy.linalg import solve, toeplitz
from scipy.signal import fftconvolve


def _project(reference_sources: np.ndarray, estimate: np.ndarray, flen: int) -> np.ndarray:
    """Least-squares projection of estimate onto span{shifted references}.

    reference_sources: (nsrc, T); estimate: (T,). Returns the (T + flen - 1,)
    projection signal.
    """
    nsrc, T = reference_sources.shape
    n_fft = int(2 ** np.ceil(np.log2(T + flen - 1)))
    sf = np.fft.rfft(reference_sources, n=n_fft, axis=1)
    sef = np.fft.rfft(estimate, n=n_fft)

    # Gram matrix G[i*flen + k, j*flen + l] = <s_i(.-k), s_j(.-l)>; each
    # block is Toeplitz in the lag difference k - l (circular correlation
    # indices wrap for negative lags).
    G = np.zeros((nsrc * flen, nsrc * flen))
    for i in range(nsrc):
        for j in range(i, nsrc):
            # ssf[d] = sum_t s_i[t+d] s_j[t]; G[k,l] = ssf[l-k].
            ssf = np.fft.irfft(sf[i] * np.conj(sf[j]), n=n_fft)
            row = ssf[:flen]  # l - k >= 0
            col = np.concatenate([ssf[:1], ssf[n_fft - flen + 1 :][::-1]])  # l - k <= 0 (wrapped)
            blk = toeplitz(col, row)
            G[i * flen : (i + 1) * flen, j * flen : (j + 1) * flen] = blk
            G[j * flen : (j + 1) * flen, i * flen : (i + 1) * flen] = blk.T

    # Cross terms D[i*flen + k] = <est, s_i(.-k)>
    D = np.zeros(nsrc * flen)
    for i in range(nsrc):
        ssef = np.fft.irfft(sef * np.conj(sf[i]), n=n_fft)
        D[i * flen : (i + 1) * flen] = ssef[:flen]

    try:
        C = solve(G + 1e-10 * np.eye(nsrc * flen), D, assume_a="pos")
    except np.linalg.LinAlgError:
        C = np.linalg.lstsq(G, D, rcond=None)[0]
    C = C.reshape(nsrc, flen)

    proj = np.zeros(T + flen - 1)
    for i in range(nsrc):
        proj += fftconvolve(C[i], reference_sources[i])[: T + flen - 1]
    return proj


def _bss_decomp(reference_sources: np.ndarray, estimate: np.ndarray, j: int, flen: int):
    """Decompose estimate into (s_true, e_spat+interf, e_artif)."""
    T = estimate.shape[0]
    padded = np.zeros(T + flen - 1)
    padded[:T] = estimate

    s_true = _project(reference_sources[j : j + 1], estimate, flen)
    p_all = _project(reference_sources, estimate, flen)
    e_interf = p_all - s_true
    e_artif = padded - p_all
    return s_true, e_interf, e_artif


def _sdr_sir_sar(s_true, e_interf, e_artif, eps: float = 1e-12):
    s_power = np.sum(s_true**2)
    sdr = 10 * np.log10((s_power + eps) / (np.sum((e_interf + e_artif) ** 2) + eps))
    sir = 10 * np.log10((s_power + eps) / (np.sum(e_interf**2) + eps))
    sar = 10 * np.log10((np.sum((s_true + e_interf) ** 2) + eps) / (np.sum(e_artif**2) + eps))
    return sdr, sir, sar


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    compute_permutation: bool = True,
    filt_len: int = 512,
):
    """(nsrc, T), (nsrc, T) -> (sdr, sir, sar, perm) arrays of shape (nsrc,).

    mir_eval.separation.bss_eval_sources semantics: 512-tap projection
    filters, the best permutation by SIR.
    """
    reference_sources = np.asarray(reference_sources, dtype=np.float64)
    estimated_sources = np.asarray(estimated_sources, dtype=np.float64)
    nsrc = reference_sources.shape[0]

    # The metrics of every (estimate, reference) pair.
    sdr = np.empty((nsrc, nsrc))
    sir = np.empty((nsrc, nsrc))
    sar = np.empty((nsrc, nsrc))
    for je in range(nsrc):
        for jt in range(nsrc):
            parts = _bss_decomp(reference_sources, estimated_sources[je], jt, filt_len)
            sdr[je, jt], sir[je, jt], sar[je, jt] = _sdr_sir_sar(*parts)

    if compute_permutation:
        best, best_perm = -np.inf, None
        for perm in itertools.permutations(range(nsrc)):
            score = np.mean([sir[je, perm[je]] for je in range(nsrc)])
            if score > best:
                best, best_perm = score, perm
        perm = np.asarray(best_perm)
    else:
        perm = np.arange(nsrc)

    idx = np.arange(nsrc)
    return sdr[idx, perm], sir[idx, perm], sar[idx, perm], perm


def _project_multichannel(reference_sources: np.ndarray, estimate: np.ndarray, flen: int) -> np.ndarray:
    """Least-squares projection of each estimate channel onto the span of
    shifted versions of ALL reference channels (images variant).

    reference_sources: (nsrc, T, C); estimate: (T, C).
    Returns (T + flen - 1, C).
    """
    nsrc, T, C = reference_sources.shape
    refs = reference_sources.transpose(0, 2, 1).reshape(nsrc * C, T)  # flatten channels
    out = np.zeros((T + flen - 1, C))
    for c in range(C):
        out[:, c] = _project(refs, estimate[:, c], flen)
    return out


def _bss_decomp_images(reference_sources: np.ndarray, estimate: np.ndarray, j: int, flen: int):
    """BSS Eval v4 (images) decomposition with GLOBAL filters.

    reference_sources: (nsrc, T, C); estimate: (T, C). Returns
    (s_true, e_spat, e_interf, e_artif), each (T + flen - 1, C).
    museval/bsseval semantics: s_true is the true source image itself;
    e_spat is what spatial filtering of the matching source adds; e_interf
    what the other sources add; e_artif the remainder.
    """
    T, C = estimate.shape
    padded = np.zeros((T + flen - 1, C))
    padded[:T] = estimate

    s_true = np.zeros((T + flen - 1, C))
    s_true[:T] = reference_sources[j]

    p_j = _project_multichannel(reference_sources[j : j + 1], estimate, flen)
    p_all = _project_multichannel(reference_sources, estimate, flen)

    e_spat = p_j - s_true
    e_interf = p_all - p_j
    e_artif = padded - p_all
    return s_true, e_spat, e_interf, e_artif


def _framewise_ratios(s_true, e_spat, e_interf, e_artif, win: int, hop: int, T: int,
                      eps: float = 1e-12):
    """Windowed SDR/ISR/SIR/SAR over the v4 decomposition.

    Returns (n_windows, 4); windows with a silent reference give NaN
    (museval EvalStore aggregates with nanmedian).
    """
    n_win = int(np.floor((T - win + hop) / hop)) if T >= win else 0
    out = np.full((max(n_win, 0), 4), np.nan)
    for k in range(n_win):
        sl = slice(k * hop, k * hop + win)
        st = s_true[sl]
        sp = e_spat[sl]
        it = e_interf[sl]
        ar = e_artif[sl]
        p_true = np.sum(st**2)
        if p_true <= eps:
            continue
        out[k, 0] = 10 * np.log10(p_true / (np.sum((sp + it + ar) ** 2) + eps))  # SDR
        out[k, 1] = 10 * np.log10(p_true / (np.sum(sp**2) + eps))  # ISR
        out[k, 2] = 10 * np.log10((np.sum((st + sp) ** 2) + eps) / (np.sum(it**2) + eps))  # SIR
        out[k, 3] = 10 * np.log10((np.sum((st + sp + it) ** 2) + eps) / (np.sum(ar**2) + eps))  # SAR
    return out


def bss_eval_v4(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    sample_rate: int,
    win: float = 1.0,
    hop: float = 1.0,
    filt_len: int = 512,
):
    """museval-style BSS Eval v4: global 512-tap distortion filters, then
    framewise SDR/ISR/SIR/SAR energy ratios over 1 s windows.

    reference_sources/estimated_sources: (nsrc, T) mono or (nsrc, T, C).
    Returns dict of (nsrc, n_windows) arrays for 'SDR', 'ISR', 'SIR', 'SAR'.
    Matches museval.evaluate defaults (mode='v4', win=hop=1 s, global
    filters, aligned sources -- no permutation search), reference
    `egs/musdb18/common/src/driver.py:301-330`.
    """
    reference_sources = np.asarray(reference_sources, dtype=np.float64)
    estimated_sources = np.asarray(estimated_sources, dtype=np.float64)
    if reference_sources.ndim == 2:
        reference_sources = reference_sources[..., None]
        estimated_sources = estimated_sources[..., None]
    nsrc, T, _ = reference_sources.shape
    win_s, hop_s = int(round(win * sample_rate)), int(round(hop * sample_rate))

    names = ("SDR", "ISR", "SIR", "SAR")
    results = {n: [] for n in names}
    for j in range(nsrc):
        parts = _bss_decomp_images(reference_sources, estimated_sources[j], j, filt_len)
        ratios = _framewise_ratios(*parts, win=win_s, hop=hop_s, T=T)
        for i, n in enumerate(names):
            results[n].append(ratios[:, i])
    return {n: np.stack(v) for n, v in results.items()}
