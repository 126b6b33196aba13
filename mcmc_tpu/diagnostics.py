"""Convergence diagnostics: split R-hat, effective sample size, summaries.

The reference reports only ``n_accept_draws`` (SURVEY.md §5); these
diagnostics are the additions the BASELINE metrics require (ESS/sec, R-hat
parity). All functions are jit-safe and batched: ``draws`` has shape
``(n_draws, n_chains, n_vals)`` (a single chain may pass ``(n_draws, n_vals)``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["split_rhat", "ess", "rank_normalized_rhat", "bulk_ess", "tail_ess",
           "hdi", "summary",
           "moments_init", "moments_update", "moments_finalize", "moments_rhat"]


def _ensure_3d(draws):
    draws = jnp.asarray(draws)
    if draws.ndim == 2:
        draws = draws[:, None, :]
    return draws


def split_rhat(draws):
    """Split-chain potential scale reduction factor (Gelman-Rubin).

    Each chain is split in half, giving m = 2 * n_chains sequences; returns
    the per-dimension R-hat vector.
    """
    draws = _ensure_3d(draws)
    n = draws.shape[0] // 2
    # (n, 2*n_chains, dim)
    halves = jnp.concatenate([draws[:n], draws[n : 2 * n]], axis=1)
    chain_means = halves.mean(axis=0)                 # (m, dim)
    chain_vars = halves.var(axis=0, ddof=1)           # (m, dim)
    w = chain_vars.mean(axis=0)
    b = n * chain_means.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / w)


def _autocov_fft(x):
    """Autocovariance along axis 0 via FFT, biased (divided by n)."""
    n = x.shape[0]
    m = _next_pow2(2 * n)
    xc = x - x.mean(axis=0, keepdims=True)
    f = jnp.fft.rfft(xc, n=m, axis=0)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=m, axis=0)[:n].real
    return acov / n


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def ess(draws, chain_chunk=None):
    """Effective sample size with Geyer's initial monotone sequence estimator,
    combined across chains (Stan-style: mean autocovariance across chains over
    the pooled variance). Returns the per-dimension ESS vector.

    ``chain_chunk=k`` computes the per-chain autocovariance FFT in chain
    blocks of ``k`` via a sequential ``lax.map`` — numerically identical,
    bounding the FFT workspace to O(k * n * dim) instead of
    O(m * n * dim). Use for large chain batches computed on device (the
    4096-chain bench line: the one-shot FFT's padded temporaries exceed
    device memory even when the draws themselves fit).
    """
    draws = _ensure_3d(draws)
    n, m, dim = draws.shape

    if chain_chunk is not None and m > int(chain_chunk):
        c = int(chain_chunk)
        if m % c != 0:
            raise ValueError(f"chain_chunk={c} must divide n_chains={m}")
        blocks = jnp.moveaxis(draws.reshape(n, m // c, c, dim), 1, 0)
        acov_sums = jax.lax.map(
            lambda b: _autocov_fft(b).sum(axis=1), blocks)   # (nb, n, dim)
        mean_acov = acov_sums.sum(axis=0) / m                # (n, dim)
    else:
        acov = _autocov_fft(draws)                    # (n, m, dim)
        mean_acov = acov.mean(axis=1)                 # (n, dim)
    chain_means = draws.mean(axis=0)                  # (m, dim)
    var_plus = mean_acov[0] * n / (n - 1)
    if m > 1:
        var_plus = var_plus + chain_means.var(axis=0, ddof=1)

    # rho_t = 1 - (W - mean_acov_t) / var_plus
    rho = 1.0 - (mean_acov[0] - mean_acov) / var_plus  # (n, dim)

    # Geyer: Stan's pairing P_k = rho_{2k} + rho_{2k+1} starting at rho_0;
    # keep while positive, enforce a monotone non-increasing envelope,
    # tau = -1 + 2 * sum(P_kept).
    n_pairs = n // 2
    pair_sums = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs : 2]  # (n_pairs, dim)

    positive = pair_sums > 0
    keep = jnp.cumprod(positive, axis=0).astype(bool)
    capped = jax.lax.associative_scan(jnp.minimum, jnp.where(keep, pair_sums, 0.0), axis=0)
    tau = -1.0 + 2.0 * jnp.sum(jnp.where(keep, capped, 0.0), axis=0)
    tau = jnp.maximum(tau, 1.0 / jnp.log10(jnp.asarray(float(n * m))))
    return n * m / tau


def _rank_normalize(draws):
    """Fractional-rank normal-score transform (Vehtari et al. 2021 eq. 14):
    pooled ranks over (draws, chains) per dimension mapped through the
    normal quantile function with the (r - 3/8)/(S + 1/4) offset."""
    n, m, dim = draws.shape
    flat = draws.reshape(n * m, dim)
    # double argsort gives 0-based ranks (ties broken by order — fine for
    # continuous draws; indicator inputs get an arbitrary-but-consistent
    # tie order, which leaves the autocorrelation structure intact)
    ranks = jnp.argsort(jnp.argsort(flat, axis=0), axis=0).astype(draws.dtype)
    z = jax.scipy.special.ndtri((ranks + 1.0 - 0.375) / (n * m + 0.25))
    return z.reshape(n, m, dim)


def _split_chains(draws):
    """Split each chain in half: (n, m, d) -> (n//2, 2m, d). The split is
    what lets within-chain nonstationarity (a drifting, unconverged chain)
    surface as between-sequence variance in the ESS estimators, matching
    Stan/arviz (Vehtari et al. 2021 §3.1)."""
    n = draws.shape[0] // 2
    return jnp.concatenate([draws[:n], draws[n : 2 * n]], axis=1)


def rank_normalized_rhat(draws):
    """Rank-normalized split R-hat (Vehtari, Gelman, Simpson, Carpenter,
    Burkner 2021): the max of split R-hat on rank-normalized draws (bulk)
    and on rank-normalized folded draws |x - median| (tails). The modern
    convergence gate — use <= 1.01 as the pass criterion."""
    draws = _ensure_3d(draws)
    z = _rank_normalize(draws)
    folded = jnp.abs(draws - jnp.median(draws, axis=(0, 1)))
    zf = _rank_normalize(folded)
    return jnp.maximum(split_rhat(z), split_rhat(zf))


def bulk_ess(draws, chain_chunk=None):
    """Bulk effective sample size: Geyer ESS of rank-normalized *split*
    chains (Vehtari et al. 2021; matches Stan/arviz ess_bulk).
    ``chain_chunk`` bounds the FFT workspace as in :func:`ess`."""
    draws = _ensure_3d(draws)
    return ess(_rank_normalize(_split_chains(draws)), chain_chunk=chain_chunk)


def tail_ess(draws, chain_chunk=None):
    """Tail effective sample size: the min of the split-chain ESS of the 5%
    and 95% quantile exceedance indicators (Vehtari et al. 2021 §4.3;
    matches Stan/arviz ess_tail). ``chain_chunk`` bounds the FFT workspace
    as in :func:`ess`."""
    draws = _ensure_3d(draws)
    q = jnp.quantile(draws, jnp.asarray([0.05, 0.95], draws.dtype), axis=(0, 1))
    split = _split_chains(draws)
    e05 = ess((split <= q[0]).astype(draws.dtype), chain_chunk=chain_chunk)
    e95 = ess((split <= q[1]).astype(draws.dtype), chain_chunk=chain_chunk)
    return jnp.minimum(e05, e95)


def moments_init(n_chains, n_vals, dtype=jnp.float32):
    """Streaming Welford accumulator over draws, per chain x dim.

    For runs too long to keep draws resident (the reference keeps everything
    in RAM — SURVEY.md §5), fold each kept draw into this pytree inside the
    scan and compute mean/var/R-hat at the end with O(chains x dims) memory.
    """
    z = jnp.zeros((n_chains, n_vals), dtype)
    return {"count": jnp.zeros((), jnp.int32), "mean": z, "m2": z}


def moments_update(m, x):
    """Fold one draw batch ``x`` of shape (n_chains, n_vals)."""
    count = m["count"] + 1
    delta = x - m["mean"]
    mean = m["mean"] + delta / count.astype(x.dtype)
    m2 = m["m2"] + delta * (x - mean)
    return {"count": count, "mean": mean, "m2": m2}


def moments_finalize(m):
    """Returns (per-chain mean, per-chain variance) arrays."""
    n = jnp.maximum(m["count"], 2).astype(m["mean"].dtype)
    return m["mean"], m["m2"] / (n - 1)


def moments_rhat(m):
    """R-hat from streaming moments (non-split: between/within-chain
    variances only, no draw storage)."""
    chain_mean, chain_var = moments_finalize(m)
    n = m["count"].astype(chain_mean.dtype)
    w = chain_var.mean(axis=0)
    b = n * chain_mean.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / w)


def hdi(draws, prob=0.94):
    """Highest-density interval of the pooled draws, per dimension.

    Sliding-window minimal-width interval over the sorted pooled sample
    (exact for unimodal posteriors; arviz's default estimator and 94%
    convention). Returns a ``(2, n_vals)`` array of (low, high) bounds.
    """
    draws = _ensure_3d(draws)
    pooled = draws.reshape(-1, draws.shape[-1])       # (N, dim)
    n = pooled.shape[0]
    srt = jnp.sort(pooled, axis=0)
    w = min(n - 1, max(1, math.floor(prob * n)))      # interval covers w+1 points
    widths = srt[w:] - srt[: n - w]                   # (n-w, dim)
    lo_ix = jnp.argmin(widths, axis=0)                # (dim,)
    cols = jnp.arange(pooled.shape[-1])
    return jnp.stack([srt[lo_ix, cols], srt[lo_ix + w, cols]])


def summary(draws, quantiles=(0.05, 0.5, 0.95), hdi_prob=0.94):
    """Posterior summary dict: mean, sd, MCSE, quantiles, HDI, split/rank
    R-hat, bulk/tail ESS. Quantile keys are ``"q5"``/``"q50"``/``"q95"``
    (percent, trailing zeros trimmed); HDI bounds are ``"hdi_low"``/
    ``"hdi_high"`` at ``hdi_prob`` mass."""
    draws = _ensure_3d(draws)
    axes = (0, 1)
    sd = draws.std(axis=axes)
    n_eff = ess(draws)
    qs = jnp.quantile(draws, jnp.asarray(quantiles, draws.dtype), axis=axes)
    bounds = hdi(draws, hdi_prob)
    out = {
        "mean": draws.mean(axis=axes),
        "sd": sd,
        "mcse": sd / jnp.sqrt(n_eff),
        "rhat": split_rhat(draws),
        "ess": n_eff,
        "rhat_rank": rank_normalized_rhat(draws),
        "ess_bulk": bulk_ess(draws),
        "ess_tail": tail_ess(draws),
        "hdi_low": bounds[0],
        "hdi_high": bounds[1],
    }
    for p, row in zip(quantiles, qs):
        out[f"q{100 * p:g}".replace(".", "_")] = row
    return out
