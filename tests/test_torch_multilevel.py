"""The multi-level ES in the port (``workflows/multilevel.py``) against the
JAX package's, on the CPU.

- ``HyperSpec``'s validation and transforms equal JAX's.
- Three outer generations of the fleet drive (OpenES groups on Sphere,
  ``lr_scale`` and ``noise_stdev`` adapted) equal JAX's outer mean, sigma
  and hyperparameter values, with JAX's draws handed to the port: the
  outer normals through ``_draw_outer`` and each group's inner noise
  through ``OpenES._draw_noise``.
- Three outer generations of the sequential drive (``fleet=False``) equal
  JAX's theta, outer mean and sigma bit for bit, and its best, score and
  group centers, with JAX's outer and inner draws handed to the port.
- The sequential drive parks a group whose farm is degraded and goes on.
- The outer update replayed on the host gives the state's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (one intra-op thread a worker process)
from evox_tpu.algorithms.so.es import OpenES as JaxOpenES
from evox_tpu.problems.numerical import Sphere as JaxSphere
from evox_tpu.workflows.multilevel import HyperSpec as JaxHyperSpec
from evox_tpu.workflows.multilevel import MultiLevelES as JaxMultiLevelES
from evox_tpu_torch.algorithms.so.es import OpenES
from evox_tpu_torch.problems.numerical import Sphere
from evox_tpu_torch.workflows.multilevel import HyperSpec, MultiLevelES

G, POP, DIM, INNER, OUTER = 4, 8, 4, 3, 3
CENTER = np.full(DIM, 2.0, np.float32)
SPECS = [dict(name="noise_stdev", init=0.3, sigma=0.4, lb=1e-3, ub=3.0),
         dict(name="lr_scale", init=1.0, sigma=0.3, lb=0.05, ub=4.0, transform="linear")]
# The outer mean and sigma come from the same proposals and elites through
# the same numpy float32 update, so they are equal bit for bit. A
# hyperparameter value is exp of the proposal, which XLA's CPU exp and
# torch's may round one ulp apart: rtol 1e-6.
HP_RTOL = 1e-6


@pytest.mark.parametrize("kw,err", [
    (dict(name="a", init=1.0), None),
    (dict(name="a", init=0.5, transform="linear", lb=-1.0, ub=1.0), None),
    (dict(name="a", init=1.0, transform="cube"), "transform"),
    (dict(name="a", init=1.0, kind="leaf"), "kind"),
    (dict(name="a", init=1.0, lb=2.0, ub=1.0), "lb < ub"),
    (dict(name="a", init=1.0, lb=0.0), "lb > 0"),
    (dict(name="a", init=5.0, lb=0.1, ub=2.0), "outside"),
])
def test_hyper_spec_validation_and_transforms_equal_jax(kw, err):
    if err is not None:
        with pytest.raises(ValueError, match=err):
            JaxHyperSpec(**kw)
        with pytest.raises(ValueError, match=err):
            HyperSpec(**kw)
        return
    js, ps = JaxHyperSpec(**kw), HyperSpec(**kw)
    v = np.array([0.1, kw["init"], 0.7, 1.3], np.float32)
    np.testing.assert_allclose(ps.to_internal(v).numpy(), np.asarray(js.to_internal(v)),
                               rtol=HP_RTOL)
    z = np.array([-30.0, -1.0, 0.0, 0.25, 40.0], np.float32)
    np.testing.assert_allclose(ps.to_external(torch.from_numpy(z)).numpy(),
                               np.asarray(js.to_external(jnp.asarray(z))), rtol=HP_RTOL)


def _noise_halves(keys, steps):
    """JAX's OpenES noise for each group's next ``steps`` asks, generation
    by generation, group by group (the order the port's fleet draws)."""
    keys = [k for k in keys]
    out = []
    for _ in range(steps):
        for i, k in enumerate(keys):
            keys[i], sub = jax.random.split(k)
            out.append(np.asarray(jax.random.normal(sub, (POP // 2, DIM))))
    return out


def test_fleet_drive_equals_jax_with_its_draws():
    jml = JaxMultiLevelES(JaxOpenES(CENTER, POP, learning_rate=0.2, noise_stdev=0.3),
                          JaxSphere(), n_groups=G, hyper_specs=[JaxHyperSpec(**s) for s in SPECS],
                          inner_steps=INNER)
    algo = OpenES(CENTER, POP, learning_rate=0.2, noise_stdev=0.3, device="cpu")
    pml = MultiLevelES(algo, Sphere(), n_groups=G, hyper_specs=[HyperSpec(**s) for s in SPECS],
                       inner_steps=INNER, device="cpu")
    js, ps = jml.init(jax.random.PRNGKey(5)), pml.init(5)
    assert pml.fleet_mode and jml.fleet_mode
    np.testing.assert_array_equal(ps.outer_mean.numpy(), np.asarray(js.outer_mean))
    eps_queue, noise_queue = [], []
    by_seed = {}

    def draw(seed):
        if seed not in by_seed:
            by_seed[seed] = torch.from_numpy(noise_queue.pop(0))
        return by_seed[seed]

    algo._draw_noise = draw
    pml._fleet.algorithm._draw_noise = draw
    pml._draw_outer = lambda seed: torch.from_numpy(eps_queue.pop(0))
    for _ in range(OUTER):
        _, k_eps = jax.random.split(js.key)
        eps_queue.append(np.asarray(jax.random.normal(k_eps, (G, len(SPECS)), jnp.float32)))
        noise_queue.extend(_noise_halves(js.inner.tenants.algo.key, INNER))
        js, ps = jml.step(js), pml.step(ps)
        assert not eps_queue and not noise_queue  # every JAX draw taken, in order
        np.testing.assert_array_equal(ps.theta.numpy(), np.asarray(js.theta))
        np.testing.assert_array_equal(ps.outer_mean.numpy(), np.asarray(js.outer_mean))
        np.testing.assert_array_equal(ps.outer_sigma.numpy(), np.asarray(js.outer_sigma))
        want = jml.hyper_values(js)
        for name, got in pml.hyper_values(ps).items():
            np.testing.assert_allclose(got, want[name], rtol=HP_RTOL, err_msg=name)
        np.testing.assert_allclose(ps.score.numpy(), np.asarray(js.score), rtol=1e-5)
    assert ps.generation == OUTER and int(js.generation) == OUTER
    rep = pml.report(ps)
    assert rep["mode"] == "fleet" and rep["active_groups"] == G
    assert set(rep["outer_mean_external"]) == {"noise_stdev", "lr_scale"}


@pytest.mark.parametrize("exploit,optimizer", [(True, "adam"), (False, None)])
def test_sequential_drive_equals_jax_with_its_draws(exploit, optimizer):
    """The sequential drive (``fleet=False``, path 38's mode: adam, the
    exploit step) against the JAX package's on Sphere: its own
    ask/evaluate/tell loop, best and score, with the JAX draws handed to
    the port in the order JAX takes them (group by group, each group's
    inner steps in turn). Theta, the
    outer mean and sigma are equal bit for bit; best, score and the
    groups' centers within rtol 1e-5, because ``noise_stdev`` is exp of
    the proposal, which XLA's CPU exp and torch's may round one ulp
    apart, and that ulp reaches every candidate."""
    kw = dict(n_groups=G, inner_steps=INNER, exploit=exploit, fleet=False)
    es = dict(learning_rate=0.2, noise_stdev=0.3, optimizer=optimizer)
    jml = JaxMultiLevelES(JaxOpenES(CENTER, POP, **es), JaxSphere(),
                          hyper_specs=[JaxHyperSpec(**s) for s in SPECS], **kw)
    pml = MultiLevelES(OpenES(CENTER, POP, device="cpu", **es), Sphere(),
                       hyper_specs=[HyperSpec(**s) for s in SPECS], device="cpu", **kw)
    assert not pml.fleet_mode and not jml.fleet_mode
    js, ps = jml.init(jax.random.PRNGKey(11)), pml.init(11)
    eps_queue, noise_queue, by_seed = [], [], {}

    def draw(seed):
        if seed not in by_seed:
            by_seed[seed] = torch.from_numpy(noise_queue.pop(0))
        return by_seed[seed]

    pml.algorithm._draw_noise = draw
    pml._draw_outer = lambda seed: torch.from_numpy(eps_queue.pop(0))
    for _ in range(OUTER):
        _, k_eps = jax.random.split(js.key)
        eps_queue.append(np.array(jax.random.normal(k_eps, (G, len(SPECS)), jnp.float32)))
        for key in js.inner.key:  # the exploit keeps each group's own key
            for _ in range(INNER):
                key, sub = jax.random.split(key)
                noise_queue.append(np.array(jax.random.normal(sub, (POP // 2, DIM))))
        js, ps = jml.step(js), pml.step(ps)
        assert not eps_queue and not noise_queue  # every JAX draw taken, in order
        for name in ("theta", "outer_mean", "outer_sigma"):
            np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
        for name in ("best", "score"):
            np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(ps.inner.center.numpy(), np.asarray(js.inner.center),
                                   rtol=1e-5, atol=1e-6)
        assert ps.active.tolist() == np.asarray(js.active).tolist()
    assert ps.generation == OUTER and int(js.generation) == OUTER
    assert pml.best_fitness(ps)[1] == pytest.approx(jml.best_fitness(js)[1], rel=1e-5)
    assert pml.report(ps)["mode"] == jml.report(js)["mode"] == "sequential"


class _Degraded(RuntimeError):
    pass


_Degraded.__name__ = "FarmDegradedError"


class _FlakyHostSphere:
    """A host problem that raises ``FarmDegradedError`` on its ``fail_at``-th
    evaluation and counts ``admit()`` calls."""

    jittable = False

    def __init__(self, fail_at):
        self.calls, self.fail_at, self.admits = 0, fail_at, 0

    def init(self, seed=None):
        return None

    def evaluate(self, state, pop):
        self.calls += 1
        if self.calls == self.fail_at:
            raise _Degraded("live workers 1 < min_workers 2")
        return (pop ** 2).sum(dim=1), state

    def admit(self):
        self.admits += 1
        return 0


def test_sequential_drive_parks_a_degraded_group_and_goes_on():
    """Group 1's farm degrades in its second inner step: it parks, its
    score stays out of the outer update, the others finish every phase,
    ``admit()`` runs before each phase, and the best never worsens."""
    prob = _FlakyHostSphere(fail_at=INNER + 2)
    ml = MultiLevelES(OpenES(CENTER, POP, learning_rate=0.2, noise_stdev=0.3, device="cpu"), prob,
                      n_groups=G, hyper_specs=[HyperSpec(**SPECS[0])], inner_steps=INNER,
                      device="cpu")
    assert not ml.fleet_mode
    state = ml.init(1)
    bests = []
    for _ in range(OUTER):
        state = ml.step(state)
        bests.append(ml.best_fitness(state)[1])
    assert state.active.tolist() == [True, False, True, True]
    lost = [e for e in ml.events if e["event"] == "group_lost"]
    assert len(lost) == 1 and lost[0]["group"] == 1 and "FarmDegradedError" in lost[0]["error"]
    assert prob.admits == OUTER
    assert prob.calls == INNER * G + INNER * (G - 1) * (OUTER - 1) + 1 - (INNER - 1)
    assert all(b2 <= b1 for b1, b2 in zip(bests, bests[1:]))
    # every candidate the groups ran lies inside the spec's bounds
    assert (ml.hyper_values(state)["noise_stdev"] <= SPECS[0]["ub"]).all()


def test_outer_update_replays_bit_for_bit_on_the_host():
    """The update is numpy float32 on the host: replaying it from the
    state's proposals and gains gives the same outer mean and sigma."""
    ml = MultiLevelES(OpenES(CENTER, POP, learning_rate=0.2, noise_stdev=0.3, device="cpu"),
                      Sphere(), n_groups=G, hyper_specs=[HyperSpec(**s) for s in SPECS],
                      inner_steps=2, sigma_decay=0.9, device="cpu")
    state = ml._run_phase(ml.init(3).replace(theta=torch.randn(G, 2, generator=torch.Generator()
                                                               .manual_seed(0))))
    gain = -state.score
    new = ml._outer_update(state, gain)
    k = max(1, int(round(ml.elite_frac * G)))
    elite = np.argsort(-gain.numpy())[:k]
    mean = (1 - ml.outer_lr) * state.outer_mean.numpy() + ml.outer_lr * \
        state.theta.numpy()[elite].mean(axis=0)
    assert np.array_equal(new.outer_mean.numpy(), mean.astype(np.float32))
    assert np.array_equal(new.outer_sigma.numpy(),
                          np.maximum(state.outer_sigma.numpy() * 0.9, 1e-4).astype(np.float32))


def test_constructor_refusals():
    algo = OpenES(CENTER, POP, device="cpu")
    with pytest.raises(ValueError, match=">= 2 groups"):
        MultiLevelES(algo, Sphere(), 1, [HyperSpec("noise_stdev", 0.1)], device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        MultiLevelES(algo, Sphere(), 2, [HyperSpec("noise_stdev", 0.1)] * 2, device="cpu")
    with pytest.raises(ValueError, match="no attribute"):
        MultiLevelES(algo, Sphere(), 2, [HyperSpec("nope", 0.1)], device="cpu")
    with pytest.raises(ValueError, match="fleet mode"):
        MultiLevelES(algo, _FlakyHostSphere(0), 2, [HyperSpec("noise_stdev", 0.1)], fleet=True,
                     device="cpu")
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiLevelES(algo, Sphere(), 2, [HyperSpec("noise_stdev", 0.1)])
