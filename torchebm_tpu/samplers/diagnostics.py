r"""Cross-chain MCMC convergence diagnostics: split-R̂ and effective sample size.

**Build addition**: the reference's diagnostics stop at per-step
batch mean/var/energy/acceptance (``base_sampler.py:21-34``); this module adds
the standard cross-chain statistics — classic split-:math:`\hat R`/ESS
(Gelman et al., *Bayesian Data Analysis* 3rd ed. §11.4-11.5) **and** the
modern rank-normalized variants practitioners trust (Vehtari, Gelman, Simpson,
Carpenter & Bürkner 2021): ``rank_normalized=True`` on both estimators,
folded-R̂ (catches variance mismatches the mean-based statistic misses), and
:func:`tail_effective_sample_size` (min ESS of the 5%/95% quantile
indicators). Everything is pure ``jnp`` and jittable, so pooled multi-host
diagnostics reduce over the chain axis with one ``psum``-backed mean when the
chain dimension is sharded over a mesh.

Convention: trajectories are ``(n_chains, n_draws, dim)`` — the layout produced
by ``BaseSampler.sample(..., return_trajectory=True)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri

Array = jax.Array

__all__ = [
    "potential_scale_reduction",
    "effective_sample_size",
    "tail_effective_sample_size",
    "summarize_chains",
]


def _split_chains(traj: Array) -> Array:
    """Split each chain in half: (C, N, D) -> (2C, N//2, D) (drops odd draw)."""
    c, n = traj.shape[0], traj.shape[1]
    half = n // 2
    first = traj[:, :half]
    second = traj[:, half : 2 * half]
    return jnp.concatenate([first, second], axis=0)


def _rank_normalize(traj: Array) -> Array:
    r"""Rank-normalize pooled draws to standard-normal z-scores.

    Vehtari et al. 2021, eq. (14): fractional ranks
    :math:`z = \Phi^{-1}\big((r - 3/8)/(S + 1/4)\big)` over the pooled
    ``S = M·N`` draws (ordinal ranks via double argsort — ties have measure
    zero for continuous MCMC draws). traj: (M, N, D) -> (M, N, D).
    """
    m, n, d = traj.shape
    flat = traj.reshape(m * n, d)
    ranks = jnp.argsort(jnp.argsort(flat, axis=0), axis=0) + 1  # 1..S
    u = (ranks.astype(jnp.float32) - 0.375) / (m * n + 0.25)
    return ndtri(u).reshape(m, n, d)


def _fold(traj: Array) -> Array:
    """Fold around the pooled median (Vehtari et al. §3.2): |x - median|."""
    med = jnp.median(traj.reshape(-1, traj.shape[-1]), axis=0)
    return jnp.abs(traj - med)


def potential_scale_reduction(
    traj: Array, split: bool = True, rank_normalized: bool = False
) -> Array:
    r"""Split-:math:`\hat R` per dimension.

    .. math::
        \hat R = \sqrt{\frac{\frac{N-1}{N} W + \frac1N B}{W}}

    with between-chain variance ``B`` and within-chain variance ``W``.
    Values near 1 indicate convergence; > 1.01 is suspect.

    Args:
        traj: ``(n_chains, n_draws, dim)`` trajectory.
        split: Use split chains (detects within-chain trends). Default True.
        rank_normalized: Compute the Vehtari et al. 2021 statistic —
            ``max(R̂(z), R̂(z_folded))`` over rank-normalized draws ``z`` and
            folded draws ``|x − median|`` (robust to heavy tails; the folded
            term catches chains agreeing in location but not scale).

    Returns:
        ``(dim,)`` array of R̂ values.
    """
    if traj.ndim == 2:
        traj = traj[..., None]
    if split:
        traj = _split_chains(traj)
    if rank_normalized:
        bulk = _rhat_raw(_rank_normalize(traj))
        folded = _rhat_raw(_rank_normalize(_fold(traj)))
        return jnp.maximum(bulk, folded)
    return _rhat_raw(traj)


def _rhat_raw(traj: Array) -> Array:
    m, n = traj.shape[0], traj.shape[1]
    chain_means = jnp.mean(traj, axis=1)  # (M, D)
    chain_vars = jnp.var(traj, axis=1, ddof=1)  # (M, D)
    w = jnp.mean(chain_vars, axis=0)
    b = n * jnp.var(chain_means, axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / jnp.maximum(w, 1e-30))


def _autocov_fft(x: Array) -> Array:
    """Per-chain autocovariance via FFT. x: (M, N) -> (M, N) lags 0..N-1."""
    n = x.shape[1]
    xc = x - jnp.mean(x, axis=1, keepdims=True)
    # zero-pad to 2n so the circular FFT correlation equals the linear one
    f = jnp.fft.rfft(xc, n=2 * n, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=2 * n, axis=1)[:, :n]
    return acov / n


def effective_sample_size(
    traj: Array, split: bool = True, rank_normalized: bool = False
) -> Array:
    r"""Effective sample size per dimension (Geyer initial-monotone estimator).

    .. math::
        \text{ESS} = \frac{MN}{1 + 2\sum_{t=1}^{T} \hat\rho_t}

    with combined-chain autocorrelations :math:`\hat\rho_t` truncated at the
    first sum of adjacent pairs that goes negative (Geyer 1992), enforced
    monotone non-increasing.

    Args:
        traj: ``(n_chains, n_draws, dim)`` trajectory.
        split: Use split chains. Default True.
        rank_normalized: Compute **bulk-ESS** (Vehtari et al. 2021) — the same
            estimator on rank-normalized draws, robust to heavy tails and the
            quantity practitioners report as ``ess_bulk``.

    Returns:
        ``(dim,)`` ESS estimates.
    """
    if traj.ndim == 2:
        traj = traj[..., None]
    if split:
        traj = _split_chains(traj)
    if rank_normalized:
        traj = _rank_normalize(traj)
    return _ess_raw(traj)


def tail_effective_sample_size(traj: Array, split: bool = True) -> Array:
    r"""Tail-ESS per dimension (Vehtari et al. 2021 §4.3).

    The minimum of the effective sample sizes of the 5% and 95% quantile
    indicator sequences :math:`I(x \le \hat q_\alpha)` — the resolution
    available for tail quantities, which bulk-ESS overstates for
    heavy-tailed or slowly-tail-mixing chains.

    Args:
        traj: ``(n_chains, n_draws, dim)`` trajectory.

    Returns:
        ``(dim,)`` tail-ESS estimates.
    """
    if traj.ndim == 2:
        traj = traj[..., None]
    if split:
        traj = _split_chains(traj)
    flat = traj.reshape(-1, traj.shape[-1])
    q05 = jnp.quantile(flat, 0.05, axis=0)
    q95 = jnp.quantile(flat, 0.95, axis=0)
    ess05 = _ess_raw((traj <= q05).astype(jnp.float32))
    ess95 = _ess_raw((traj <= q95).astype(jnp.float32))
    return jnp.minimum(ess05, ess95)


def _ess_raw(traj: Array) -> Array:
    m, n, d = traj.shape

    def per_dim(x):  # x: (M, N)
        acov = _autocov_fft(x)  # (M, N)
        chain_var = acov[:, 0] * n / jnp.maximum(n - 1, 1)  # (M,)
        w = jnp.mean(chain_var)
        mean_acov = jnp.mean(acov, axis=0)  # (N,)
        if m > 1:
            b_over_n = jnp.var(jnp.mean(x, axis=1), ddof=1)
        else:
            b_over_n = jnp.float32(0.0)
        var_plus = (n - 1) / n * w + b_over_n
        rho = 1.0 - (w - mean_acov) / jnp.maximum(var_plus, 1e-30)  # (N,)

        # Geyer pairs: P_k = rho_{2k} + rho_{2k+1}; truncate at first negative,
        # then force monotone non-increasing.
        n_pairs = n // 2
        pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
        positive = pairs > 0
        keep = jnp.cumprod(positive.astype(jnp.float32))
        pairs = pairs * keep
        pairs = jax.lax.associative_scan(jnp.minimum, pairs)
        pairs = jnp.maximum(pairs, 0.0)
        # tau = -1 + 2 * sum P_k  (rho_0 = 1 included in the first pair)
        tau = -1.0 + 2.0 * jnp.sum(pairs)
        return m * n / jnp.maximum(tau, 1.0 / jnp.float32(m * n))

    return jax.vmap(per_dim, in_axes=2)(traj)


def summarize_chains(traj: Array, rank_normalized: bool = False) -> dict:
    """Convenience bundle: mean, std, split-R̂, ESS per dimension.

    With ``rank_normalized=True`` adds the Vehtari et al. 2021 statistics
    ``r_hat_rank`` (max of bulk and folded rank-R̂), ``ess_bulk`` and
    ``ess_tail``.
    """
    if traj.ndim == 2:
        traj = traj[..., None]
    flat = traj.reshape(-1, traj.shape[-1])
    out = {
        "mean": jnp.mean(flat, axis=0),
        "std": jnp.std(flat, axis=0),
        "r_hat": potential_scale_reduction(traj),
        "ess": effective_sample_size(traj),
        "n_chains": traj.shape[0],
        "n_draws": traj.shape[1],
    }
    if rank_normalized:
        out["r_hat_rank"] = potential_scale_reduction(traj, rank_normalized=True)
        out["ess_bulk"] = effective_sample_size(traj, rank_normalized=True)
        out["ess_tail"] = tail_effective_sample_size(traj)
    return out
