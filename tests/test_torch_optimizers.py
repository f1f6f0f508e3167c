"""The port's optimizers (``evox_tpu_torch/utils/optimizers.py``) against
optax 0.2.6, which the JAX package resolves by name, on the CPU: every
optimizer name ``make_optimizer`` resolves, 30 updates on the same
gradients and parameters at two hyperparameter settings (rmsprop three),
the state carried across by ``interop.optimizer_state``, and the names the
port refuses."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.utils.optimizers import make_optimizer as jax_make_optimizer
from evox_tpu_torch import interop
from evox_tpu_torch.utils.optimizers import OPTIMIZERS, make_optimizer

DIM, STEPS = 64, 30
# Each name's second setting moves what it can: momentum and nesterov,
# weight decay and its mask, the moments' rates, eps, thresholds.
SETTINGS = {
    "sgd": [{}, dict(momentum=0.9, nesterov=True)],
    "sign_sgd": [{}, {}],
    "noisy_sgd": [{}, dict(eta=0.1, gamma=0.3)],
    "adam": [{}, dict(b1=0.8, eps_root=1e-8, nesterov=True)],
    "nadam": [{}, dict(b2=0.99, eps=1e-6)],
    "adamw": [{}, dict(weight_decay=0.05, nesterov=True)],
    "nadamw": [{}, dict(weight_decay=0.02, mask=False)],
    "amsgrad": [{}, dict(b1=0.7, eps_root=1e-6)],
    "adamax": [{}, dict(b1=0.8, eps=1e-4)],
    "adamaxw": [{}, dict(weight_decay=0.05)],
    "radam": [{}, dict(threshold=6.0, nesterov=True)],
    "yogi": [{}, dict(b1=0.8, eps=1e-4)],
    "adabelief": [{}, dict(nesterov=True, eps=1e-8)],
    "adan": [{}, dict(weight_decay=0.01, b1=0.9)],
    "lion": [{}, dict(b1=0.95, weight_decay=0.0)],
    "lamb": [{}, dict(weight_decay=0.01)],
    "lars": [{}, dict(weight_decay=0.01, nesterov=True, trust_coefficient=0.01)],
    "novograd": [{}, dict(weight_decay=0.01, b2=0.5)],
    "adagrad": [{}, dict(initial_accumulator_value=0.5)],
    "adadelta": [{}, dict(rho=0.5, weight_decay=0.01)],
    "adafactor": [{}, dict(momentum=0.9, weight_decay_rate=0.01, clipping_threshold=None)],
    # centered with bias_correction is left out: at the first step it takes
    # rsqrt(g**2 - g**2 + eps), where an FMA's rounding decides the result
    "rmsprop": [{}, dict(centered=True, momentum=0.9, nesterov=True, eps_in_sqrt=False),
                dict(bias_correction=True, initial_scale=0.1)],
    "rprop": [{}, dict(eta_plus=1.5)],
    "sm3": [{}, dict(momentum=0.5)],
    "fromage": [{}, dict(min_norm=1e-3)],
    "optimistic_gradient_descent": [{}, dict(alpha=0.5, beta=2.0)],
    "optimistic_adam": [{}, dict(optimism=0.1)],
    "optimistic_adam_v2": [{}, dict(alpha=0.5, beta=0.3)],
}
CASES = [(name, i) for name, sets in SETTINGS.items() for i in range(len(sets))]

# The port does optax's float32 operations in optax's order, with the
# count's powers correctly rounded as XLA's jitted pow gives them. XLA fuses
# a product and a sum into one FMA where PyTorch rounds twice, and sums a
# norm or a mean in another order: ~1 ulp of the larger terms a step,
# measured at most 6e-7 of the update's largest entry over 30 steps. The
# bound, 2e-6 of the largest entry, holds the updates and the states.
TOL = 2e-6


def _numpy_state(state):
    """An optax state as numpy leaves (a PRNG key as its key data)."""
    def leaf(x):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return np.asarray(jax.random.key_data(x))
        return np.asarray(x)

    return jax.tree.map(leaf, state)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    assert err <= TOL * scale, f"{what}: {err:.3e} against {TOL} x {scale:.3e}"


def _noise_from(jstate, g):
    """optax's add_noise draw of this step, from the JAX state's key."""
    noise_state = next(s for s in jstate if hasattr(s, "rng_key"))
    _, sample_key = jax.random.split(noise_state.rng_key)
    return np.array(optax.tree.random_like(sample_key, target_tree=jnp.asarray(g),
                                             sampler=jax.random.normal))


@pytest.mark.parametrize("name,setting", CASES, ids=[f"{n}-{i}" for n, i in CASES])
def test_optimizer_matches_optax(name, setting):
    kwargs = SETTINGS[name][setting]
    lr = 0.01 if setting == 0 else 0.1
    rng = np.random.default_rng(setting)
    params = rng.normal(size=DIM).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # optimistic_adam's and noisy_sgd's deprecations
        jopt = jax_make_optimizer(name, lr, **kwargs)
        topt = make_optimizer(name, lr, **kwargs)
    assert type(topt) is OPTIMIZERS[name]
    jupdate = jax.jit(jopt.update)  # the JAX package runs it inside a jitted tell
    jstate, tstate = jopt.init(jnp.asarray(params)), topt.init(torch.from_numpy(params))
    for step in range(STEPS):
        g = (rng.normal(size=DIM) * (0.5 + step % 3)).astype(np.float32)
        if name == "noisy_sgd":
            noise = torch.from_numpy(_noise_from(jstate, g))
            topt._draw = lambda seed, like, n=noise: n
        ju, jstate = jupdate(jnp.asarray(g), jstate, jnp.asarray(params))
        tu, tstate = topt.update(torch.from_numpy(g), tstate, torch.from_numpy(params))
        _close(tu.numpy(), ju, f"{name} update {step}")
        params = params + np.asarray(ju)  # both go on from the JAX package's parameters
    # the state: each field of the port's by optax's name
    theirs = interop._optax_fields(_numpy_state(jstate))
    carried = interop.optimizer_state(topt, _numpy_state(jstate), torch.device("cpu"))
    fields = [] if isinstance(tstate, tuple) else [
        f for f in type(tstate).__dataclass_fields__ if getattr(tstate, f) is not None]
    for field in fields:
        ours = getattr(tstate, field)
        if isinstance(ours, torch.Tensor):
            want = theirs[field][0] if isinstance(theirs[field], list) else theirs[field]
            _close(ours.numpy(), want, f"{name} state {field}")
            np.testing.assert_array_equal(getattr(carried, field).numpy(), want)
        elif field in theirs:  # counts and flags (noisy_sgd's seed and a plain
            # rmsprop's count are the port's own: optax keeps a key, and no count)
            assert ours == getattr(carried, field) == np.asarray(theirs[field]), field


def test_every_resolved_name_is_an_optax_optimizer():
    """The port resolves exactly optax's optimizer aliases that take a
    gradient, with optax's keyword names."""
    import inspect

    assert set(SETTINGS) == set(OPTIMIZERS)
    for name, cls in OPTIMIZERS.items():
        ours = list(inspect.signature(cls).parameters)
        theirs = [p for p in inspect.signature(getattr(optax, name)).parameters]
        assert ours == theirs, name


@pytest.mark.parametrize("name,reason", [
    ("lbfgs", "objective's value"), ("polyak_sgd", "objective's value"),
    ("dpsgd", "per-example"), ("clip", "gradient transformation"),
    ("trace", "gradient transformation"), ("scale_by_adam", "gradient transformation"),
    ("no_such_optimizer", "unknown optimizer"),
])
def test_refused_names(name, reason):
    with pytest.raises(ValueError, match=reason):
        make_optimizer(name, 0.1)
    if name == "no_such_optimizer":  # the JAX package's own error
        with pytest.raises(ValueError, match="unknown optimizer"):
            jax_make_optimizer(name, 0.1)


def test_optimizers_that_read_params_require_them():
    """Optimizers that decay or scale by the parameters raise without them,
    as optax does."""
    for name in ("adamw", "lamb", "lars", "fromage", "novograd", "adafactor"):
        opt = make_optimizer(name, 0.1)
        state = opt.init(torch.zeros(3))
        with pytest.raises(ValueError, match="parameters"):
            opt.update(torch.ones(3), state)
