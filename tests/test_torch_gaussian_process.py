"""The Gaussian-process layer of the port (``operators/gaussian_process``)
against the JAX package on the CPU: GP regression's fit and predictions,
the batched fit against per-item fits, the NaN of a failed Cholesky, and
GP classification (Laplace) and the probit label regression."""

import jax
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.operators.gaussian_process import GPClassification as JaxGPClassification
from evox_tpu.operators.gaussian_process import GPRegression as JaxGPRegression
from evox_tpu.operators.gaussian_process import ProbitLabelRegression as JaxProbit
from evox_tpu.operators.gaussian_process.classification import (
    _laplace_neg_evidence as jax_neg_evidence,
)
from evox_tpu_torch.operators.gaussian_process import (
    GPClassification,
    GPRegression,
    ProbitLabelRegression,
)
from evox_tpu_torch.operators.gaussian_process.classification import _laplace_neg_evidence

# A fit is adam on a float32 marginal likelihood through a Cholesky. XLA and
# PyTorch factor and sum in other orders, so the gradients differ in their
# last bits; adam's first steps move each parameter by about the learning
# rate times the gradient's sign, and a gradient near zero can flip that
# sign. Over 50 steps at lr 0.1 the log-parameters stay within 1e-3 of
# JAX's (measured: 1e-4), the predictions of sin within 1e-3 and their
# variance within 1e-5 of values up to ~1e-4.
PARAM_ATOL = 1e-3
MEAN_ATOL, VAR_ATOL = 1e-3, 1e-5
# The batched fit runs the same arithmetic as one item's fit (the items'
# losses are summed, so each gradient is its own): equal to float32 noise.
BATCH_ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(p):
    return np.array([p.log_lengthscale, p.log_variance, p.log_noise], dtype=np.float32)


@pytest.fixture(scope="module")
def sine():
    x = np.linspace(0.0, 2.0 * np.pi, 24).astype(np.float32)
    y = np.sin(x).astype(np.float32)
    xt = np.linspace(0.3, 5.9, 17).astype(np.float32)
    jgp = JaxGPRegression(fit_steps=50)
    jmodel = jax.jit(jgp.fit)(x, y)
    jmean, jvar = jgp.predict(jmodel, xt)
    return x, y, xt, jmodel, np.asarray(jmean), np.asarray(jvar)


def test_regression_fit_and_predict_match_jax(sine):
    x, y, xt, jmodel, jmean, jvar = sine
    gp = GPRegression(fit_steps=50, device="cpu")
    model = gp.fit(_t(x), _t(y))
    np.testing.assert_allclose(model[0].packed().numpy(), _params(jmodel[0]), atol=PARAM_ATOL)
    mean, var = gp.predict(model, _t(xt))
    np.testing.assert_allclose(mean.numpy(), jmean, atol=MEAN_ATOL)
    np.testing.assert_allclose(var.numpy(), jvar, atol=VAR_ATOL)
    np.testing.assert_allclose(mean.numpy(), np.sin(xt), atol=0.1)  # JAX's own law
    # sample on injected normals: mean + sqrt(var) * z
    z = np.random.default_rng(0).normal(size=xt.shape).astype(np.float32)
    got = gp.sample(0, model, _t(xt), z=_t(z))
    np.testing.assert_allclose(got.numpy(), mean.numpy() + np.sqrt(var.numpy()) * z, rtol=1e-6)


def test_batched_fit_equals_per_item_fits():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(2, 3, 12)).astype(np.float32)
    y = (np.sin(4 * x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    xt = rng.uniform(size=(2, 3, 5)).astype(np.float32)
    gp = GPRegression(fit_steps=10, device="cpu")
    batched = gp.fit(_t(x), _t(y))
    b_mean, b_var = gp.predict(batched, _t(xt))
    for i in range(2):
        for j in range(3):
            item = gp.fit(_t(x[i, j]), _t(y[i, j]))
            np.testing.assert_allclose(batched[0].packed()[i, j].numpy(),
                                       item[0].packed().numpy(), atol=BATCH_ATOL)
            mean, var = gp.predict(item, _t(xt[i, j]))
            np.testing.assert_allclose(b_mean[i, j].numpy(), mean.numpy(), atol=BATCH_ATOL)
            np.testing.assert_allclose(b_var[i, j].numpy(), var.numpy(), atol=BATCH_ATOL)
    # and one item against the JAX package's fit of it
    jmodel = JaxGPRegression(fit_steps=10).fit(x[1, 2], y[1, 2])
    np.testing.assert_allclose(batched[0].packed()[1, 2].numpy(), _params(jmodel[0]),
                               atol=PARAM_ATOL)


@pytest.mark.parametrize("fit_steps", [0, 3])
def test_failed_cholesky_gives_nan_as_jax(fit_steps):
    # duplicate inputs at variance 1e8: the kernel is exactly rank one in
    # float32 (the 1e-6 jitter vanishes), so the factorisation fails
    x = np.zeros(6, np.float32)
    y = np.arange(6, dtype=np.float32)
    jgp = JaxGPRegression(variance=1e8, noise=1e-30, fit_steps=fit_steps)
    jmodel = jgp.fit(x, y)
    jmean, jvar = jax.jit(jgp.predict)(jmodel, x)
    gp = GPRegression(variance=1e8, noise=1e-30, fit_steps=fit_steps, device="cpu")
    model = gp.fit(_t(x), _t(y))
    mean, var = gp.predict(model, _t(x))
    assert np.isnan(np.asarray(jmean)).all() and np.isnan(np.asarray(jvar)).all()
    assert torch.isnan(mean).all() and torch.isnan(var).all()
    # a failed fit's gradient is NaN too, so the parameters go NaN as JAX's
    np.testing.assert_array_equal(np.isnan(model[0].packed().numpy()),
                                  np.isnan(_params(jmodel[0])))


def _blobs(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n // 2, 2)) * 0.35 + np.array([-1.0, 0.0])
    b = rng.normal(size=(n // 2, 2)) * 0.35 + np.array([1.0, 0.0])
    x = np.concatenate([a, b]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n // 2)]).astype(np.float32)
    return x, y


# Laplace: 15 Newton steps, each a Cholesky of B; the latent mode and the
# probabilities agree with XLA's to float32 noise through the iteration
# (measured ~1e-6); with adam steps through the Newton solve the fitted
# log-parameters stay within PARAM_ATOL, as regression's do.
PROBA_ATOL = 1e-4


def test_laplace_classification_matches_jax():
    fit_steps = 5  # the hyperparameter fit through the Newton solve, then the mode
    x, y = _blobs(0, 40)
    xt = np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, 0.0], [0.3, -0.2]], np.float32)
    jclf = JaxGPClassification(lengthscale=0.8, fit_steps=fit_steps)

    @jax.jit
    def jax_side(x, y, xt):  # one compiled program for every JAX reference
        m = jclf.fit(x, y)
        return m, jclf.predict_proba(m, xt), jclf.predict_proba(m, x), jax_neg_evidence(
            m.params, m.x, m.y, 15)

    jmodel, jproba, jproba_train, jevidence = jax_side(x, y, xt)
    clf = GPClassification(lengthscale=0.8, fit_steps=fit_steps, device="cpu")
    model = clf.fit(_t(x), _t(y))
    np.testing.assert_allclose(model.params.packed().numpy(), _params(jmodel.params),
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(model.f_hat.numpy(), np.asarray(jmodel.f_hat), atol=1e-3)
    np.testing.assert_allclose(clf.predict_proba(model, _t(xt)).numpy(), np.asarray(jproba),
                               atol=PROBA_ATOL)
    labels = clf.predict_label(model, _t(x))
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), (np.asarray(jproba_train) > 0.5).astype(np.int32))
    assert (labels.numpy() == y.astype(np.int32)).mean() >= 0.95
    np.testing.assert_allclose(float(_laplace_neg_evidence(model.params, model.x, model.y, 15)),
                               float(jevidence), rtol=1e-4)


def test_probit_label_regression_matches_jax():
    x, y = _blobs(1, 30)
    xt, _ = _blobs(2, 10)
    jbase = JaxProbit(lengthscale=0.8, fit_steps=0)
    want = np.asarray(jax.jit(lambda x, y, xt: jbase.predict_proba(jbase.fit(x, y), xt))(x, y, xt))
    base = ProbitLabelRegression(lengthscale=0.8, fit_steps=0, device="cpu")
    model = base.fit(_t(x), _t(y))
    np.testing.assert_allclose(base.predict_proba(model, _t(xt)).numpy(), want, atol=PROBA_ATOL)
    np.testing.assert_array_equal(base.predict_label(model, _t(xt)).numpy(),
                                  (want > 0.5).astype(np.int32))


def test_entry_points_default_to_cuda():
    for make in (GPRegression, GPClassification, ProbitLabelRegression):
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
