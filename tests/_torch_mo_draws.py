"""The JAX package's draws for the port's MO algorithms, rebuilt from a JAX
state's key as each JAX module splits it, as torch tensors the port's
``_draw`` methods (or its operators' draw arguments) take."""

import functools

import jax
import numpy as np
import torch

from evox_tpu.algorithms.so.de import de as jde

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


def tournament_ga(jalgo, key):
    """A GA-skeleton ask with a binary tournament (IBEA, SPEA2, KnEA, BiGE;
    mo/common.py): the contestants from ``k_mate``, the variation's draws."""
    n, d = jalgo.pop_size, jalgo.dim
    _, k_mate, k_var = jax.random.split(key, 3)
    return {"contestants": t(jax.random.randint(k_mate, (n, 2), 0, n)),
            **ga_variation(k_var, n, d)}


def hype(jalgo, key, mc_mate, mc_select):
    """HypE.ask's draws (hype.py): ``k_mate`` splits into the mating score's
    Monte Carlo key and the tournament's; the selection's uniforms come from
    the key that ask leaves (HypE.tell)."""
    n, d, m, s = jalgo.pop_size, jalgo.dim, jalgo.n_objs, jalgo.n_samples
    key_after, k_mate, k_var = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_mate)
    out = {"contestants": t(jax.random.randint(k2, (n, 2), 0, n)), **ga_variation(k_var, n, d)}
    if mc_mate:
        out["u_mate"] = t(jax.random.uniform(k1, (s, m)))
    if mc_select:
        _, k_h = jax.random.split(key_after)
        out["u_select"] = t(jax.random.uniform(k_h, (s, m)))
    return out


def sra(jalgo, key, pc=None):
    """SRA's draws (sra.py): the mating permutation and the variation from
    ask's keys; the selection's ``pc``, permutation and per-sweep uniforms
    from ``fold_in(key after ask, 7)``, one split per sweep."""
    n, d = jalgo.pop_size, jalgo.dim
    key_after, k_mate, k_var = jax.random.split(key, 3)
    out = {"perm_mate": t(jax.random.permutation(k_mate, n)), **ga_variation(k_var, n, d)}
    k = jax.random.fold_in(key_after, 7)
    k, k_pc, k_perm = jax.random.split(k, 3)
    out["pc"] = t(jax.random.uniform(k_pc) * 0.2 + 0.4) if pc is None else pc
    out["perm"] = t(jax.random.permutation(k_perm, 2 * n))
    rows = []
    for _ in range(jalgo.sweeps):
        k, k_choice = jax.random.split(k)
        rows.append(np.asarray(jax.random.uniform(k_choice, (2 * n,))))
    out["u_sweeps"] = t(np.stack(rows))
    return out


def bce_ibea(jalgo, key, even):
    """BCEIBEA's ask (bce_ibea.py): the NPC round's tournament and
    variation, or the exploration's partners, SBX over pop pairs and the
    mutation of pop children."""
    n, d = jalgo.pop_size, jalgo.dim
    _, k_sel, k_x, k_m = jax.random.split(key, 4)
    if even:
        return {"contestants": t(jax.random.randint(k_sel, (n, 2), 0, n)),
                **variation(k_x, k_m, n // 2, n, d)}
    return {"partner": t(jax.random.randint(k_sel, (n,), 0, n)), **variation(k_x, k_m, n, n, d)}


def gde3(jalgo, key):
    """GDE3.ask (gde3.py): three distinct other rows, the crossover's
    uniforms and ``j_rand``."""
    n, d = jalgo.pop_size, jalgo.dim
    _, ki, kcr, kj = jax.random.split(key, 4)
    return {"idx": t(jde.select_rand_indices(ki, n, 3)),
            "u_cr": t(jax.random.uniform(kcr, (n, d))),
            "j_rand": t(jax.random.randint(kj, (n, 1), 0, d))}
