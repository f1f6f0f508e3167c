"""The JAX package's draws for the port's MO algorithms, rebuilt from a JAX
state's key as each JAX module splits it, as torch tensors the port's
``_draw`` methods (or its operators' draw arguments) take."""

import functools

import jax
import numpy as np
import torch

from evox_tpu_torch.algorithms.mo import common as mo_common
from evox_tpu_torch.operators.crossover import simulated_binary
from evox_tpu_torch.operators.mutation import polynomial


def t(x):
    return torch.from_numpy(np.array(x))


def variation(k_x, k_m, n_pairs, n_rows, dim):
    """SBX's ``u`` from ``k_x`` (sbx.py) and polynomial mutation's ``site``
    and ``u`` from ``k_m`` (mutation/ops.py)."""
    k1, k2 = jax.random.split(k_m)
    return {"u_sbx": t(jax.random.uniform(k_x, (n_pairs, dim))),
            "site": t(jax.random.uniform(k1, (n_rows, dim)) < 1.0 / dim),
            "u_pm": t(jax.random.uniform(k2, (n_rows, dim)))}


def ga_variation(k_var, n, dim):
    """``GAMOAlgorithm.variation``'s draws (mo/common.py)."""
    k1, k2 = jax.random.split(k_var)
    return variation(k1, k2, n // 2, n, dim)


def moead(jalgo, key):
    """MOEAD.ask (moead.py)."""
    n, d = jalgo.pop_size, jalgo.dim
    _, k_pick, k_x, k_m = jax.random.split(key, 4)
    return {"picks": t(jax.random.randint(k_pick, (n,), 0, jalgo.T)), **variation(k_x, k_m, n, n, d)}


def moeaddra(jalgo, key):
    """MOEADDRA.ask (moead_variants.py)."""
    n, d = jalgo.pop_size, jalgo.dim
    _, k_tour, k_pick, k_x, k_m = jax.random.split(key, 5)
    return {"cand": t(jax.random.randint(k_tour, (n, 10), 0, n)),
            "picks": t(jax.random.randint(k_pick, (n, 2), 0, jalgo.T)),
            **variation(k_x, k_m, n, n, d)}


def moeadm2m(jalgo, key):
    """MOEADM2M.ask (moead_variants.py)."""
    n, d = jalgo.pop_size, jalgo.dim
    _, k_pick, k_x, k_m = jax.random.split(key, 4)
    return {"mate": t(jax.random.randint(k_pick, (n,), 0, jalgo.S)), **variation(k_x, k_m, n, n, d)}


def choice_uniform(key, shape):
    """The uniform ``jax.random.choice(key, n, shape, p=p)`` draws (with
    replacement): it searches ``cumsum(p)`` for ``total * (1 - u)``."""
    return t(jax.random.uniform(key, shape))


def eagmoead(jalgo, key):
    """EAGMOEAD.ask (eag_moead.py): the subproblem draw's uniforms (the
    port works out the probabilities from its success history)."""
    n, d = jalgo.pop_size, jalgo.dim
    _, k_sel, k_pick, k_x, k_m = jax.random.split(key, 5)
    k_p1, k_p2 = jax.random.split(k_pick)
    return {"u_sub": choice_uniform(k_sel, (n,)),
            "i1": t(jax.random.randint(k_p1, (n,), 0, jalgo.T)),
            "i2": t(jax.random.randint(k_p2, (n,), 0, jalgo.T)),
            **variation(k_x, k_m, n, n, d)}


def rvea(jalgo, jstate):
    """RVEA.ask (rvea.py): the mating draw's uniforms (the port works out
    the probabilities, its rows of finite fitness)."""
    rows, d = jstate.population.shape
    _, k_mate, k_var = jax.random.split(jstate.key, 3)
    return {"u_mate": choice_uniform(k_mate, (rows,)), **ga_variation(k_var, rows, d)}


def rveaa_directions(jalgo, key):
    """RVEAa.tell's regeneration draw (rveaa.py), from the key after ask."""
    _, k_regen = jax.random.split(key)
    return t(jax.random.uniform(k_regen, (jalgo.v0.shape[0], jalgo.n_objs)))


def lmocso(jalgo, key):
    """LMOCSO.ask (lmocso.py)."""
    n, d = jalgo.pop_size, jalgo.dim
    half = n // 2
    _, k_pair, k0, k1, k_m = jax.random.split(key, 5)
    kk1, kk2 = jax.random.split(k_m)
    return {"perm": t(jax.random.permutation(k_pair, n)),
            "r0": t(jax.random.uniform(k0, (half, d))), "r1": t(jax.random.uniform(k1, (half, d))),
            "site": t(jax.random.uniform(kk1, (half, d)) < 1.0 / d),
            "u_pm": t(jax.random.uniform(kk2, (half, d)))}


def inject_ga(monkeypatch, talgo, key):
    """Hand a GA-skeleton algorithm (NSGA3, TDEA) JAX's mating permutation
    and variation draws for the ask after ``key`` (mo/common.py)."""
    n, d = talgo.pop_size, talgo.dim
    _, k_mate, k_var = jax.random.split(key, 3)
    perm = t(jax.random.permutation(k_mate, n))
    draws = ga_variation(k_var, n, d)
    monkeypatch.setattr(talgo, "mate", lambda seed, state: state.population[perm])
    monkeypatch.setattr(mo_common, "simulated_binary",
                        functools.partial(simulated_binary, u=draws["u_sbx"]))
    monkeypatch.setattr(mo_common, "polynomial",
                        functools.partial(polynomial, site=draws["site"], u=draws["u_pm"]))
