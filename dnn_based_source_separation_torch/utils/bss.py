"""BSS Eval v3 source metrics: SDR / SIR / SAR with the optimal permutation.

The port's own copy of `bss_eval_sources` of
`dnn_based_source_separation_tpu/utils/bss.py` (:21-122), bit for bit: the
reference's `src/utils/bss.py:4-30` wraps `mir_eval.separation.bss_eval_sources`,
re-implemented there from the BSS Eval v3 definition (Vincent et al., 2006).
The estimate is decomposed by least-squares projections onto 512-tap delayed
versions of the true source (s_true) and of all sources (s_true + e_interf);
the remainder is e_artif. Host-side numpy and scipy; the FFT-based Toeplitz
Gram assembly keeps it fast. `bss_eval_v4` (museval) comes with slice C.
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
