"""The accelerator check, the compile-cache helper, and the precision pin of
the GLM targets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_tpu import device, models
from mcmc_tpu.ops.fused_logreg import glm_log_density


def test_require_accelerator_refuses_the_cpu():
    with pytest.raises(device.AcceleratorMissing, match="no gpu device"):
        device.require_accelerator("gpu")


def test_require_accelerator_accepts_an_explicit_cpu_rehearsal():
    assert device.require_accelerator("cpu").platform == "cpu"


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_the_env_var(monkeypatch, tmp_path,
                                           cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_compile_cache_defaults_to_a_fixed_checkout_path(monkeypatch,
                                                         cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = device.enable_compile_cache()
    assert first == device.enable_compile_cache()
    assert first.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    repo = device.CACHE_DIR.parent
    assert (repo / "mcmc_tpu" / "device.py").exists()


def _flagship_like(n=200, d=12):
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0), n, d)
    return X, y


def _f64_logistic(X, y, B, prior_scale=10.0):
    Xd, yd, Bd = (np.asarray(a, np.float64) for a in (X, y, B))
    eta = Bd @ Xd.T
    return (yd * eta - np.logaddexp(0.0, eta)).sum(1) \
        - 0.5 * (Bd ** 2).sum(1) / prior_scale ** 2


@pytest.mark.parametrize("build", [
    lambda X, y: models.logistic_regression_model(X, y),
    lambda X, y: glm_log_density(X, y, 10.0, "logistic"),
], ids=["logistic_regression_model", "glm_log_density"])
def test_glm_density_matches_float64(build):
    """f32 density within 1e-5 relative of the same math in float64."""
    X, y = _flagship_like()
    lk = build(X, y)
    B = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (64, X.shape[1]))
    lp = np.asarray(jax.jit(jax.vmap(lk))(B), np.float64)
    ref = _f64_logistic(X, y, B)
    assert np.max(np.abs(lp - ref) / np.abs(ref)) <= 1e-5


@pytest.mark.parametrize("build", [
    lambda X, y: models.logistic_regression_model(X, y),
    lambda X, y: models.poisson_regression_model(X, y),
    lambda X, y: models.student_t_regression_model(X, y),
    lambda X, y: glm_log_density(X, y, 10.0, "probit"),
], ids=["logistic", "poisson", "student_t", "glm_probit"])
def test_glm_data_products_pin_highest_precision(build):
    """Every f32 data product of the GLM densities — value and gradient —
    asks for precision=HIGHEST, so no GPU runs it in TF32."""
    X, y = _flagship_like()
    lk = build(X, y)
    jaxpr = jax.make_jaxpr(jax.value_and_grad(lk))(jnp.zeros(X.shape[1]))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_bf16_model_keeps_its_bf16_product():
    X, y = _flagship_like()
    lk = models.logistic_regression_model(X, y, matmul_dtype=jnp.bfloat16)
    jaxpr = jax.make_jaxpr(lk)(jnp.zeros(X.shape[1]))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert [e.invars[0].aval.dtype for e in dots] == [jnp.bfloat16]
