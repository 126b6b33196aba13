"""Fused Pallas HMC trajectory vs the plain XLA leapfrog — numerical
equivalence (Pallas interpreter on the CPU; the compiled Triton kernel in
the ``gpu``-marked tests) and statistical behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_tpu import models
from mcmc_tpu.ops.fused_logreg import (
    make_fused_hmc_step, make_fused_trajectory, make_gaussian_hmc_step,
    make_gaussian_trajectory, make_xla_hmc_step, make_xla_trajectory,
    glm_log_density, studentt_link)

D, N, L, EPS = 10, 64, 3, 0.05
# interpreter-sized tiles: 16 chains per block, 32 observations per tile
SMALL = dict(block_chains=16, obs_tile=32, interpret=True)


def _setup():
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0), N, D)
    return X, y


def _padded_start(n_chains, d, Dp, seed=1):
    z0 = 0.1 * jax.random.normal(jax.random.PRNGKey(seed), (n_chains, d))
    p0 = jax.random.normal(jax.random.PRNGKey(seed + 1), (n_chains, d))
    zp = jnp.zeros((n_chains, Dp)).at[:, :d].set(z0)
    pp = jnp.zeros((n_chains, Dp)).at[:, :d].set(p0)
    return z0, p0, zp, pp


def _leapfrog(lk, z, p, eps, n_leap):
    grad = jax.vmap(jax.grad(lk))
    for _ in range(n_leap):
        p = p + 0.5 * eps * grad(z)
        z = z + eps * p
        p = p + 0.5 * eps * grad(z)
    return z, p, -jax.vmap(lk)(z)


def _assert_traj_close(out, ref, d, name=""):
    z1, p1, U1 = out
    z2, p2, U2 = ref
    # bf16 matmuls: loose-but-meaningful agreement
    np.testing.assert_allclose(np.asarray(z1[:, :d]), np.asarray(z2),
                               rtol=2e-2, atol=2e-2, err_msg=name)
    np.testing.assert_allclose(np.asarray(p1[:, :d]), np.asarray(p2),
                               rtol=2e-2, atol=2e-2, err_msg=name)
    np.testing.assert_allclose(np.asarray(U1), np.asarray(U2), rtol=2e-2,
                               atol=0.5, err_msg=name)
    # padding columns must stay exactly zero
    assert float(jnp.abs(z1[:, d:]).max(initial=0.0)) == 0.0


def test_fused_trajectory_matches_xla_leapfrog():
    X, y = _setup()
    lk = models.logistic_regression_model(X, y, prior_scale=10.0)
    traj = make_fused_trajectory(X, y, 10.0, EPS, L, **SMALL)
    z0, p0, zp, pp = _padded_start(32, D, traj.dim_padded)
    _assert_traj_close(traj(zp, pp), _leapfrog(lk, z0, p0, EPS, L), D)


@pytest.mark.parametrize("n_chains,n_data,obs_tile", [
    (20, 64, 32),    # chains not a multiple of the chain block
    (16, 50, 32),    # observations not a multiple of the tile
    (37, 75, 16),    # neither; three observation tiles plus a partial one
])
def test_fused_trajectory_pads_chains_and_observations(n_chains, n_data,
                                                       obs_tile):
    """The wrapper pads the chain axis to the chain block and the data rows
    to the observation tile; padded rows contribute nothing and padded
    chains are sliced off."""
    X, y, _ = models.make_logistic_regression_data(
        jax.random.PRNGKey(4), n_data, D)
    lk = models.logistic_regression_model(X, y, prior_scale=10.0)
    traj = make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=16,
                                 obs_tile=obs_tile, interpret=True)
    assert traj.dim_padded == 16
    z0, p0, zp, pp = _padded_start(n_chains, D, traj.dim_padded)
    out = traj(zp, pp)
    assert [a.shape for a in out] == [(n_chains, 16), (n_chains, 16),
                                      (n_chains,)]
    _assert_traj_close(out, _leapfrog(lk, z0, p0, EPS, L), D)


def test_fused_trajectory_names_the_triton_route():
    """Every fused pallas_call names its backend and Triton launch
    parameters (an unnamed one goes to Mosaic GPU on this JAX)."""
    X, y = _setup()
    traj = make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=16,
                                 num_warps=8, num_stages=3, interpret=True)
    jaxpr = jax.make_jaxpr(traj)(jnp.zeros((32, 16)), jnp.zeros((32, 16)))
    calls = [e for e in jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    params = calls[0].params
    assert params["backend"] == "triton"
    tp = params["compiler_params"]["triton"]
    assert (tp.num_warps, tp.num_stages) == (8, 3)
    assert params["grid_mapping"].grid == (2,)


def test_fused_hmc_step_samples_posterior():
    X, y = _setup()
    step = make_fused_hmc_step(X, y, step_size=0.08, n_leap=5, **SMALL)
    n_chains = 32
    state = step.init(0.1 * jax.random.normal(jax.random.PRNGKey(3), (n_chains, D)))

    def body(carry, _):
        st, k = carry
        k, sub = jax.random.split(k)
        st, info = step(sub, st)
        return (st, k), (st.position, info["accepted"])

    (_, _), (traj, acc) = jax.lax.scan(body, (state, jax.random.PRNGKey(4)),
                                       None, length=600)
    acc = np.asarray(acc)
    assert acc.mean() > 0.5  # small steps: healthy acceptance

    # compare posterior mean vs standard HMC on the same model
    import mcmc_tpu
    lk = models.logistic_regression_model(X, y, prior_scale=10.0)
    ref = mcmc_tpu.hmc(jnp.zeros(D), lk,
                       mcmc_tpu.HMCSettings(n_burnin_draws=500, n_keep_draws=600,
                                            step_size=0.08, n_leap_steps=5),
                       n_chains=16, key=jax.random.PRNGKey(5))
    fused_mean = np.asarray(traj[300:, :, :D]).mean(axis=(0, 1))
    ref_mean = np.asarray(ref.draws).mean(axis=(0, 1))
    np.testing.assert_allclose(fused_mean, ref_mean, atol=0.3)


def test_xla_hmc_step_matches_fused_transition():
    """The plain XLA transition (the kernel's timing and test reference)
    and the fused one draw the same momenta and accept decisions from one
    key (dim 16 needs no column padding), so one transition from the same
    state lands on the same positions up to the bf16 tolerance."""
    d = 16
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0), N, d)
    lk = models.logistic_regression_model(X, y, prior_scale=10.0)
    fused = make_fused_hmc_step(X, y, step_size=EPS, n_leap=L, **SMALL)
    plain = make_xla_hmc_step(lk, d, step_size=EPS, n_leap=L)
    assert fused.dim_padded == plain.dim_padded == d
    pos = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (32, d))
    s_f, s_x = fused.init(pos), plain.init(pos)
    np.testing.assert_allclose(np.asarray(s_f.potential),
                               np.asarray(s_x.potential), rtol=1e-6)
    key = jax.random.PRNGKey(7)
    (s_f, i_f), (s_x, i_x) = fused(key, s_f), plain(key, s_x)
    assert float(np.mean(np.asarray(i_f["accepted"])
                         == np.asarray(i_x["accepted"]))) >= 0.9
    both = np.asarray(i_f["accepted"] & i_x["accepted"])
    assert both.sum() >= 16
    np.testing.assert_allclose(np.asarray(s_f.position[both]),
                               np.asarray(s_x.position[both]),
                               rtol=2e-2, atol=2e-2)


def test_fused_trajectory_glm_links():
    """Poisson and linear links in the fused kernel match the XLA gradient
    path (interpret mode)."""
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    n, d = 48, 6
    X = jax.random.normal(k1, (n, d)) * 0.3
    for link in ("poisson", "linear"):
        if link == "poisson":
            y = jax.random.poisson(k2, jnp.exp(X @ jnp.ones(d) * 0.2)).astype(jnp.float32)
            def lk(b):
                eta = X @ b
                return jnp.sum(y * eta - jnp.exp(eta)) - 0.5 * jnp.sum(b**2) / 100.0
        else:
            y = X @ jnp.ones(d) + 0.1 * jax.random.normal(k2, (n,))
            def lk(b):
                eta = X @ b
                return jnp.sum(-0.5 * (y - eta) ** 2) - 0.5 * jnp.sum(b**2) / 100.0

        traj = make_fused_trajectory(X, y, 10.0, 0.02, 3, link=link, **SMALL)
        z0, p0, zp, pp = _padded_start(16, d, traj.dim_padded)
        _assert_traj_close(traj(zp, pp), _leapfrog(lk, z0, p0, 0.02, 3), d,
                           link)


def test_fused_gaussian_trajectory_matches_xla():
    """The multivariate-Gaussian fori_loop trajectory equals the unrolled
    XLA leapfrog on the same target."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, D))
    P = jnp.asarray(A @ A.T / D + np.eye(D), jnp.float32)
    mean = jnp.asarray(rng.normal(size=D), jnp.float32)

    traj = make_gaussian_trajectory(P, mean, step_size=EPS, n_leap=L)
    assert traj.dim_padded == D
    n_chains = 16
    z0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (n_chains, D))
    p0 = jax.random.normal(jax.random.PRNGKey(2), (n_chains, D))
    z_f, p_f, u_f = traj(z0, p0)

    def xla_leapfrog(z, p):
        grad = lambda zz: -P @ (zz - mean)
        for _ in range(L):
            p = p + 0.5 * EPS * grad(z)
            z = z + EPS * p
            p = p + 0.5 * EPS * grad(z)
        u = 0.5 * (z - mean) @ (P @ (z - mean))
        return z, p, u

    z_x, p_x, u_x = jax.vmap(xla_leapfrog)(z0, p0)
    np.testing.assert_allclose(np.asarray(z_f), np.asarray(z_x),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(p_f), np.asarray(p_x),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(u_f), np.asarray(u_x),
                               rtol=2e-4, atol=2e-4)
    # a runtime step size overrides the built-in one
    z_e, _, _ = traj(z0, p0, 0.5 * EPS)
    assert not np.allclose(np.asarray(z_e), np.asarray(z_f))


def test_fused_gaussian_hmc_step_samples_target():
    """The MVN HMC step samples N(mean, P^{-1})."""
    var = jnp.array([0.5, 2.0, 1.0, 4.0])
    P = jnp.diag(1.0 / var)
    mean = jnp.array([1.0, -1.0, 0.5, 2.0])
    step = make_gaussian_hmc_step(P, mean, step_size=0.4, n_leap=5)
    st = step.init(jnp.zeros((32, 4)))
    key = jax.random.PRNGKey(0)

    def body(carry, _):
        st, k = carry
        k, sub = jax.random.split(k)
        st, info = step(sub, st)
        return (st, k), st.position[:, :4]

    (st, _), draws = jax.lax.scan(body, (st, key), None, length=400)
    d = np.asarray(draws[100:]).reshape(-1, 4)
    np.testing.assert_allclose(d.mean(axis=0), np.asarray(mean), atol=0.25)
    np.testing.assert_allclose(d.var(axis=0), np.asarray(var), rtol=0.35)


def test_fused_trajectory_custom_link_hook():
    """A callable link reproducing the built-in logistic family must match
    the built-in exactly (the pluggable eta -> (mu, ll) hook)."""
    X, y = _setup()

    def logistic_hook(eta, yv):
        return jax.nn.sigmoid(eta), yv * eta - jax.nn.softplus(eta)

    t_builtin = make_fused_trajectory(X, y, 10.0, EPS, L, link="logistic",
                                      **SMALL)
    t_custom = make_fused_trajectory(X, y, 10.0, EPS, L, link=logistic_hook,
                                     **SMALL)
    _, _, z0, p0 = _padded_start(16, D, t_builtin.dim_padded)
    zb, pb, ub = t_builtin(z0, p0)
    zc, pc, uc = t_custom(z0, p0)
    np.testing.assert_array_equal(np.asarray(zb), np.asarray(zc))
    np.testing.assert_array_equal(np.asarray(ub), np.asarray(uc))


def _probit_and_studentt_cases():
    key = jax.random.PRNGKey(17)
    k1, k2 = jax.random.split(key)
    n, d = 48, 6
    X = jax.random.normal(k1, (n, d)) * 0.4

    def ndtr(eta):
        return 0.5 * (1.0 + jax.lax.erf(eta / jnp.sqrt(2.0)))

    y_pro = (jax.random.uniform(k2, (n,)) < ndtr(X @ jnp.ones(d) * 0.5)
             ).astype(jnp.float32)

    def lk_probit(b):
        cdf = jnp.clip(ndtr(X @ b), 1e-30, 1.0 - 1e-7)
        return (jnp.sum(y_pro * jnp.log(cdf) + (1 - y_pro) * jnp.log(1 - cdf))
                - 0.5 * jnp.sum(b ** 2) / 100.0)

    y_t = X @ jnp.ones(d) + 0.3 * jax.random.t(k2, 4.0, (n,))

    def lk_t(b):
        r = y_t - X @ b
        return (jnp.sum(-0.5 * 5.0 * jnp.log1p(r * r / 4.0))
                - 0.5 * jnp.sum(b ** 2) / 100.0)

    return X, [("probit", "probit", y_pro, lk_probit),
               ("studentt", studentt_link(4.0), y_t, lk_t)]


def test_fused_trajectory_probit_and_studentt_links():
    """Probit (built-in, non-canonical) and Student-t (callable factory)
    links: fused-kernel gradient path matches jax.grad of the exact
    log-posterior, and the returned potential matches the exact U
    (interpret mode; bf16 matmul tolerance)."""
    X, cases = _probit_and_studentt_cases()
    d = X.shape[1]
    for name, link, y, lk in cases:
        traj = make_fused_trajectory(X, y, 10.0, 0.02, 3, link=link, **SMALL)
        z0, p0, zp, pp = _padded_start(16, d, traj.dim_padded)
        _assert_traj_close(traj(zp, pp), _leapfrog(lk, z0, p0, 0.02, 3), d,
                           name)


def test_fused_sampler_entry_points():
    """fused_glm_hmc / fused_gaussian_hmc return SamplerResults whose
    posteriors match the generic samplers (interpret mode, small shapes)."""
    from mcmc_tpu.ops import fused_glm_hmc, fused_gaussian_hmc
    import mcmc_tpu

    X, y = _setup()
    out = fused_glm_hmc(X, y, step_size=0.08, n_leap=5, n_chains=64,
                        n_burnin_draws=300, n_keep_draws=400,
                        key=jax.random.PRNGKey(3), interpret=True)
    assert out.draws.shape == (400, 64, D)
    assert 0.5 < float(out.diagnostics["accept_rate_per_chain"].mean()) <= 1.0
    lk = models.logistic_regression_model(X, y, prior_scale=10.0)
    ref = mcmc_tpu.hmc(jnp.zeros(D), lk,
                       mcmc_tpu.HMCSettings(n_burnin_draws=300,
                                            n_keep_draws=400,
                                            step_size=0.08, n_leap_steps=5),
                       n_chains=64, key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(np.asarray(out.draws).mean(axis=(0, 1)),
                               np.asarray(ref.draws).mean(axis=(0, 1)),
                               atol=0.3)

    # ill-conditioned diagonal Gaussian: marginal variances recovered
    variances = jnp.array([1.0, 4.0, 25.0, 100.0])
    outg = fused_gaussian_hmc(1.0 / variances, step_size=0.8, n_leap=20,
                              n_chains=16, n_burnin_draws=200,
                              n_keep_draws=600, key=jax.random.PRNGKey(6))
    assert outg.draws.shape == (600, 16, 4)
    emp = np.asarray(outg.draws).reshape(-1, 4).var(axis=0)
    np.testing.assert_allclose(emp, np.asarray(variances), rtol=0.35)


# --------------------------------------------------------------------------
# the compiled Triton kernel: skip without a GPU, run by chip_smoke.py
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("link", ["logistic", "probit", "studentt"])
def test_fused_trajectory_compiled_matches_reference(gpu, link):
    """The compiled kernel at the default tiles against the plain leapfrog
    at precision=HIGHEST, with chain and observation counts that are not
    tile multiples (75 logistic rows pad to 96, not a power of two)."""
    X, cases = _probit_and_studentt_cases()
    if link == "logistic":
        X, y, _ = models.make_logistic_regression_data(
            jax.random.PRNGKey(0), 75, D)
        link_arg = "logistic"
    else:
        _, link_arg, y, _ = dict((c[0], c) for c in cases)[link]
    d = X.shape[1]
    traj = make_fused_trajectory(X, y, 10.0, 0.02, 3, link=link_arg)
    z0, p0, zp, pp = _padded_start(100, d, traj.dim_padded)
    ref = make_xla_trajectory(glm_log_density(X, y, 10.0, link_arg), 0.02, 3)
    _assert_traj_close(jax.jit(traj)(zp, pp), jax.jit(ref)(z0, p0), d, link)


@pytest.mark.gpu
def test_fused_glm_hmc_compiled_samples_posterior(gpu):
    """fused_glm_hmc with the compiled kernel recovers the posterior mean of
    the generic HMC sampler."""
    import mcmc_tpu
    from mcmc_tpu.ops import fused_glm_hmc

    X, y = _setup()
    out = fused_glm_hmc(X, y, step_size=0.08, n_leap=5, n_chains=256,
                        n_burnin_draws=300, n_keep_draws=400,
                        key=jax.random.PRNGKey(3))
    lk = models.logistic_regression_model(X, y, prior_scale=10.0)
    ref = mcmc_tpu.hmc(jnp.zeros(D), lk,
                       mcmc_tpu.HMCSettings(n_burnin_draws=300,
                                            n_keep_draws=400,
                                            step_size=0.08, n_leap_steps=5),
                       n_chains=256, key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(np.asarray(out.draws).mean(axis=(0, 1)),
                               np.asarray(ref.draws).mean(axis=(0, 1)),
                               atol=0.1)
