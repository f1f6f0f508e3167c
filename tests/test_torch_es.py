"""The rest of the ES family of the port against the JAX package, on the
CPU: MA-ES, LM-MA-ES, RM-ES, XNES, SeparableNES, SNES, CR-FM-NES, PGPE with
ClipUp and adam, ARS (its top-k on ``partial_topk``), ASEBO, GuidedES,
PersistentES, NoiseReuseES, ESMC, DES and the two AMaLGaMs, each compared
field by field over four generations with JAX's draws handed to the port
(``algo._draw``) and tied fitness where the module sorts; the sign-free
parts of the eigendecompositions and QRs; and the family's convergence
thresholds (``tests/test_so_es.py``'s) through the port's EvalMonitor."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jit_once
from evox_tpu.algorithms.so import es as jes
from evox_tpu.algorithms.so.es import nes as jnes
from evox_tpu_torch import StdWorkflow, interop
from evox_tpu_torch.algorithms.so import es as tes
from evox_tpu_torch.algorithms.so.es import nes as tnes
from evox_tpu_torch.kernels import partial_topk
from evox_tpu_torch.monitors import EvalMonitor
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.utils import rank_based_fitness

# Each generation is float32 products over pop (<= 24) and dim (7) and
# elementwise updates; XLA and PyTorch sum the products in other orders (~1
# ulp each), and four generations compound it through sigma, M, B and the
# optimizers' normalisations. 1e-5 relative and 2e-6 absolute hold every
# field of every case.
RTOL, ATOL = 1e-5, 2e-6
DIM = 7


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(key, shape):
    return _t(jax.random.normal(key, shape))


def _tied(pop):
    """A shifted Sphere's root on a coarse grid, its last candidate tied with
    its first: tied fitness among candidates."""
    x = np.asarray(pop, np.float64)
    fit = np.round(np.sqrt(np.sum((x - 0.3) ** 2, axis=1)) * 2.0).astype(np.float32)
    fit[-1] = fit[0]
    return fit


# JAX's draws of an ask, from the state the ask receives, in the form of the
# port's ``_draw``
def _one(shape_of):
    def draws(algo, s):
        _, k = jax.random.split(s.key)
        return _normal(k, shape_of(algo))
    return draws


_POP = _one(lambda a: (a.pop_size, a.dim))
_HALF = _one(lambda a: (a.pop_size // 2, a.dim))
_PAIRS = _one(lambda a: (a.n_pairs, a.dim))


def _rmes_draws(algo, s):
    _, kz, kr = jax.random.split(s.key, 3)
    return _normal(kz, (algo.pop_size, algo.dim)), _normal(kr, (algo.pop_size, algo.m))


def _ars_draws(algo, s):
    _, k = jax.random.split(s.key)
    return _normal(k, (algo.n_dirs, algo.dim))


def _subspace_draws(algo, s):
    _, k1, k2 = jax.random.split(s.key, 3)
    return _normal(k1, (algo.n_pairs, algo.dim)), _normal(k2, (algo.n_pairs, algo.k))


def _jax_basis(field):
    """JAX's QR basis of the archive the ask and the tell both read."""
    def basis(algo, s):
        return _t(jnp.linalg.qr(getattr(s, field).T)[0])
    return basis


center = np.linspace(-1.5, 2.5, DIM).astype(np.float32)

# name: (class, kwargs, JAX's draws, JAX's subspace basis or None)
CASES = {
    "MAES": ("MAES", dict(center_init=center, init_stdev=1.0, pop_size=16), _POP, None),
    "LMMAES": ("LMMAES", dict(center_init=center, init_stdev=1.0, pop_size=16, memory_size=3),
               _POP, None),
    "LMMAES-capped": ("LMMAES", dict(center_init=center, init_stdev=1.0, pop_size=24, mu=5),
                      _POP, None),
    "RMES": ("RMES", dict(center_init=center, init_stdev=1.0, pop_size=16), _rmes_draws, None),
    # memory 3 and T = dim 7 > 4 generations: the archive replaces its newest
    "RMES-m3": ("RMES", dict(center_init=center, init_stdev=0.5, pop_size=12, memory_size=3),
                _rmes_draws, None),
    "XNES": ("XNES", dict(center_init=center, init_stdev=1.0, pop_size=16), _POP, None),
    "SeparableNES": ("SeparableNES", dict(center_init=center, init_stdev=1.0, pop_size=16), _POP,
                     None),
    "SNES": ("SNES", dict(center_init=center, init_stdev=1.0, pop_size=16), _POP, None),
    "SNES-temp": ("SNES", dict(center_init=center, init_stdev=1.0, pop_size=16, weight_type="temp"),
                  _POP, None),
    "CR_FM_NES": ("CR_FM_NES", dict(center_init=center, init_stdev=1.0, pop_size=15), _HALF, None),
    "PGPE-clipup": ("PGPE", dict(pop_size=16, center_init=center), _HALF, None),
    "PGPE-adam": ("PGPE", dict(pop_size=16, center_init=center, optimizer="adam"), _HALF, None),
    "ARS": ("ARS", dict(center_init=center, pop_size=40, learning_rate=0.1), _ars_draws, None),
    "ASEBO": ("ASEBO", dict(center_init=center, pop_size=16, subspace_dims=2, optimizer="adam"),
              _subspace_draws, _jax_basis("grad_archive")),
    "GuidedES": ("GuidedES", dict(center_init=center, pop_size=16, subspace_dims=2),
                 _subspace_draws, _jax_basis("grad_subspace")),
    "PersistentES": ("PersistentES", dict(center_init=center, pop_size=16, truncation_length=3),
                     _PAIRS, None),
    "NoiseReuseES": ("NoiseReuseES", dict(center_init=center, pop_size=16, truncation_length=3,
                                          optimizer="adam"), _PAIRS, None),
    "ESMC": ("ESMC", dict(center_init=center, pop_size=17), _PAIRS, None),
    "DES": ("DES", dict(center_init=center, init_stdev=1.0, pop_size=16), _POP, None),
    "AMaLGaM": ("AMaLGaM", dict(center_init=center, init_stdev=1.0, pop_size=24), _POP, None),
    "IndependentAMaLGaM": ("IndependentAMaLGaM", dict(center_init=center, init_stdev=1.0,
                                                      pop_size=24), _POP, None),
}


def _assert_tree(ours, theirs, name):
    if isinstance(ours, torch.Tensor):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    elif dataclasses.is_dataclass(ours):  # the port's optimizer states
        leaf = theirs[0] if isinstance(theirs, tuple) and not hasattr(theirs, "_fields") else theirs
        for f in dataclasses.fields(ours):
            _assert_tree(getattr(ours, f.name), getattr(leaf, f.name), f"{name}.{f.name}")
    elif isinstance(ours, int):
        assert ours == int(np.asarray(theirs)), name


def _assert_states(tstate, jstate):
    for f in dataclasses.fields(tstate):
        if hasattr(jstate, f.name):  # not the keys: the port holds seeds
            _assert_tree(getattr(tstate, f.name), getattr(jstate, f.name), f.name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_es_family_generations_match_jax(case):
    name, kwargs, draws, basis = CASES[case]
    jalgo = getattr(jes, name)(**kwargs)
    talgo = getattr(tes, name)(**kwargs, device="cpu")
    assert talgo.pop_size == jalgo.pop_size
    jstate = jalgo.init(jax.random.PRNGKey(7))
    tstate = interop.es_state(talgo, _numpy_tree(jstate), seed=3)
    _assert_states(tstate, jstate)  # the initial state crossed
    for gen in range(4):
        talgo._draw = lambda seed, d=draws(jalgo, jstate): d
        if basis is not None:
            talgo._basis = lambda archive, q=basis(jalgo, jstate): q
        jpop, jstate = jit_once(jalgo, "ask")(jstate)
        tpop, tstate = talgo.ask(tstate)
        np.testing.assert_allclose(tpop.numpy(), np.asarray(jpop), rtol=RTOL, atol=ATOL)
        fit = _tied(jpop)
        assert len(np.unique(fit)) < len(fit)  # ties, for the modules that sort
        jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
        tstate = talgo.tell(tstate, _t(fit))
        _assert_states(tstate, jstate)


def test_nes_utilities_match_jax():
    for n in (4, 15, 16, 1000):
        np.testing.assert_allclose(tnes.nes_utilities(n).numpy(), np.asarray(jnes.nes_utilities(n)),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n,degenerate", [(6, False), (12, True)], ids=["distinct", "degenerate"])
def test_expm_sym_matches_jax(n, degenerate):
    """V exp(w) V^T is free of V's column signs and of the basis chosen in a
    degenerate eigenspace, so it compares directly."""
    rng = np.random.default_rng(n)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.where(np.arange(n) < 4, 0.3, -0.2) if degenerate else rng.normal(size=n) * 0.5
    m = ((q * w) @ q.T).astype(np.float32)
    # eigh to ~n eps, then exp and a product of n terms: 1e-5
    np.testing.assert_allclose(tnes._expm_sym(_t(m)).numpy(), np.asarray(jnes._expm_sym(m)),
                               rtol=1e-5, atol=1e-5)
    m[1, 2] = np.nan  # JAX's eigh gives NaN; the port gives NaN too, with no exception
    assert np.isnan(tnes._expm_sym(_t(m)).numpy()).all()
    assert np.isnan(np.asarray(jnes._expm_sym(m))).all()


@pytest.mark.parametrize("name,field", [("ASEBO", "grad_archive"), ("GuidedES", "grad_subspace")])
def test_subspace_basis_matches_jax_as_a_projector(name, field):
    """The port's own QR basis: Q Q^T (free of Q's column signs) equals
    JAX's, and Q^T Q = I."""
    rng = np.random.default_rng(1)
    algo = getattr(tes, name)(center_init=np.zeros(9), pop_size=8, subspace_dims=3, device="cpu")
    archive = rng.normal(size=(3, 9)).astype(np.float32)
    Q = algo._basis(_t(archive)).numpy().astype(np.float64)
    jQ = np.asarray(jnp.linalg.qr(jnp.asarray(archive).T)[0], np.float64)
    np.testing.assert_allclose(Q @ Q.T, jQ @ jQ.T, rtol=0, atol=1e-6)
    np.testing.assert_allclose(Q.T @ Q, np.eye(3), rtol=0, atol=1e-6)


def test_amalgam_cholesky_failure_gives_nan_as_jax():
    """A covariance that is not positive definite: jnp.linalg.cholesky gives
    NaN, so every candidate is NaN; the port gives the same, with no
    exception."""
    kw = dict(center_init=np.zeros(4, np.float32), init_stdev=1.0, pop_size=16)
    jalgo, talgo = jes.AMaLGaM(**kw), tes.AMaLGaM(**kw, device="cpu")
    C = -np.eye(4, dtype=np.float32)
    jstate = jalgo.init(jax.random.PRNGKey(0)).replace(C=jnp.asarray(C))
    tstate = talgo.init(0).replace(C=_t(C))
    jpop, _ = jit_once(jalgo, "ask")(jstate)
    tpop, _ = talgo.ask(tstate)
    assert np.isnan(np.asarray(jpop)).all() and torch.isnan(tpop).all()


def test_ars_top_k_with_ties_equals_lax_top_k():
    """ARS's top directions with tied scores (and -0.0 against +0.0): the
    port's partial_topk gives lax.top_k(-score)'s indices, in its order, and
    a tell on such fitness matches JAX's."""
    score = np.array([3.0, 1.0, 1.0, -0.0, 0.0, 1.0, -2.0, -2.0, 5.0, 1.0], np.float32)
    for k in (1, 3, 5, 10):
        _, want = jax.lax.top_k(-jnp.asarray(score), k)
        _, got = partial_topk(_t(score), k, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw = dict(center_init=np.zeros(3, np.float32), pop_size=20, elite_ratio=0.3)
    jalgo, talgo = jes.ARS(**kw), tes.ARS(**kw, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(2))
    tstate = interop.es_state(talgo, _numpy_tree(jstate))
    talgo._draw = lambda seed, d=_ars_draws(jalgo, jstate): d
    _, jstate = jit_once(jalgo, "ask")(jstate)
    _, tstate = talgo.ask(tstate)
    fit = np.concatenate([score, score[::-1]])
    jstate = jit_once(jalgo, "tell")(jstate, jnp.asarray(fit))
    tstate = talgo.tell(tstate, _t(fit))
    _assert_states(tstate, jstate)


def test_noise_reuse_es_draws_only_at_a_window_start():
    algo = tes.NoiseReuseES(np.zeros(4), 8, truncation_length=3, device="cpu")
    state = algo.init(0)
    noises = []
    for _ in range(6):
        pop, state = algo.ask(state)
        noises.append(state.noise)
        state = algo.tell(state, torch.sum(pop**2, dim=1))
    assert torch.equal(noises[0], noises[1]) and torch.equal(noises[1], noises[2])
    assert not torch.equal(noises[2], noises[3]) and torch.equal(noises[3], noises[5])


def test_guided_es_tell_gradient_matches_jax():
    kw = dict(center_init=np.zeros(5, np.float32), pop_size=8, subspace_dims=3)
    jalgo, talgo = jes.GuidedES(**kw), tes.GuidedES(**kw, device="cpu")
    jstate = jalgo.init(jax.random.PRNGKey(0))
    tstate = interop.es_state(talgo, _numpy_tree(jstate))
    g = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(talgo.tell_gradient(tstate, _t(g)).grad_subspace.numpy(),
                                  np.asarray(jalgo.tell_gradient(jstate, jnp.asarray(g)).grad_subspace))


ENTRY_POINTS = {
    **{case: (lambda name=name, kw=kw: (lambda **dev: getattr(tes, name)(**kw, **dev)))()
       for case, (name, kw, _, _) in CASES.items()},
    "CMAES": lambda **dev: tes.CMAES(center, 1.0, **dev),
    "SepCMAES": lambda **dev: tes.SepCMAES(center, 1.0, **dev),
    "IPOPCMAES": lambda **dev: tes.IPOPCMAES(center, 1.0, **dev),
    "BIPOPCMAES": lambda **dev: tes.BIPOPCMAES(center, 1.0, **dev),
    "RestartCMAESDriver": lambda **dev: tes.RestartCMAESDriver(center, 1.0, lambda p: p, **dev),
}


@pytest.mark.parametrize("case", sorted(ENTRY_POINTS))
def test_es_entry_points_refuse_a_missing_cuda(case, monkeypatch):
    """device=None means cuda: without a card every ES entry point raises;
    asked for the CPU, it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = ENTRY_POINTS[case]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    built = make(device="cpu")
    assert built.device == torch.device("cpu")
    if case != "RestartCMAESDriver":
        assert built.center_init.device.type == "cpu"
        pop, _ = built.ask(built.init(0))
        assert pop.device.type == "cpu" and pop.shape[0] == built.pop_size


def test_es_family_refuses_bad_pop_sizes():
    for name in ("PGPE", "ARS", "ASEBO", "GuidedES", "PersistentES", "NoiseReuseES"):
        kw = dict(pop_size=7, center_init=np.zeros(3), device="cpu")
        with pytest.raises(ValueError, match="even"):
            getattr(tes, name)(**kw)
    with pytest.raises(ValueError, match="odd"):
        tes.ESMC(np.zeros(3), 8, device="cpu")


# ------------------------------------------------ convergence thresholds


def _sphere_best(algo, steps, fit_transforms=(), seed=17):
    mon = EvalMonitor(device="cpu")
    wf = StdWorkflow(algo, Sphere(), monitors=[mon], fit_transforms=fit_transforms, device="cpu")
    state = wf.run(wf.init(seed), steps)
    return float(mon.get_best_fitness(state.monitors[0]))


D5 = 5  # tests/test_so_es.py's DIM and thresholds
C3 = np.full(D5, 3.0)
CONVERGENCE = {
    "OpenES": (lambda: tes.OpenES(np.full(D5, 5.0), 100, learning_rate=0.05, noise_stdev=0.2,
                                  optimizer="adam", device="cpu"), 500, True, 1.0),
    "PGPE-clipup": (lambda: tes.PGPE(100, np.full(D5, 5.0), optimizer="clipup", device="cpu"),
                    300, True, 0.1),
    "PGPE-adam": (lambda: tes.PGPE(100, np.full(D5, 5.0), optimizer="adam", device="cpu"), 300,
                  True, 0.1),
    "XNES": (lambda: tes.XNES(C3, 1.0, pop_size=16, device="cpu"), 200, False, 0.01),
    "SeparableNES": (lambda: tes.SeparableNES(C3, 1.0, pop_size=32, device="cpu"), 300, False, 0.1),
    "SNES": (lambda: tes.SNES(C3, 1.0, pop_size=32, device="cpu"), 300, False, 0.1),
    "ARS": (lambda: tes.ARS(C3, pop_size=64, learning_rate=0.1, device="cpu"), 300, False, 0.5),
    "MAES": (lambda: tes.MAES(C3, 1.0, pop_size=16, device="cpu"), 200, False, 0.01),
    "LMMAES": (lambda: tes.LMMAES(C3, 1.0, pop_size=16, device="cpu"), 300, False, 0.1),
    "RMES": (lambda: tes.RMES(C3, 1.0, pop_size=32, device="cpu"), 400, False, 0.1),
    "AMaLGaM": (lambda: tes.AMaLGaM(C3, 1.0, pop_size=64, device="cpu"), 300, False, 0.1),
    "IndependentAMaLGaM": (lambda: tes.IndependentAMaLGaM(C3, 1.0, pop_size=64, device="cpu"), 300,
                           False, 0.1),
    "DES": (lambda: tes.DES(C3, 1.0, pop_size=32, device="cpu"), 300, False, 0.1),
    "ESMC": (lambda: tes.ESMC(C3, 101, learning_rate=0.5, noise_stdev=0.2, optimizer="adam",
                              device="cpu"), 400, False, 1.0),
    "GuidedES": (lambda: tes.GuidedES(C3, 64, subspace_dims=2, learning_rate=0.5, noise_stdev=0.2,
                                      optimizer="adam", device="cpu"), 400, False, 1.0),
    "PersistentES": (lambda: tes.PersistentES(C3, 64, truncation_length=10, learning_rate=0.3,
                                              noise_stdev=0.2, optimizer="adam", device="cpu"), 400,
                     False, 1.0),
    "NoiseReuseES": (lambda: tes.NoiseReuseES(C3, 64, truncation_length=10, learning_rate=0.3,
                                              noise_stdev=0.2, optimizer="adam", device="cpu"), 400,
                     False, 1.0),
    "ASEBO": (lambda: tes.ASEBO(C3, 64, subspace_dims=3, learning_rate=0.5, noise_stdev=0.2,
                                optimizer="adam", device="cpu"), 400, False, 1.0),
    "CR_FM_NES": (lambda: tes.CR_FM_NES(C3, 1.0, pop_size=32, device="cpu"), 300, False, 0.1),
}


@pytest.mark.parametrize("case", sorted(CONVERGENCE))
def test_es_family_converges_on_sphere(case):
    make, steps, shaped, threshold = CONVERGENCE[case]
    transforms = (rank_based_fitness,) if shaped else ()
    assert _sphere_best(make(), steps, transforms) < threshold
