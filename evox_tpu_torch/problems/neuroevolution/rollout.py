"""Policy-rollout problem — the port of
``evox_tpu/problems/neuroevolution/rollout.py::PolicyRolloutProblem``.

Two engines, as in the JAX package:

- the scan engine: plain PyTorch over ``(pop, episodes)`` env batches, one
  step at a time, either for a fixed ``T`` or until every episode is done
  (``early_exit``). It is the engine-level reference.
- the fused engine (``fused_env=``): the whole episode of every env in one
  call of :func:`~evox_tpu_torch.kernels.rollout.fused_rollout` — the CUDA
  kernel for tensors on the card.
- the big-policy fused engine (``fused_planes=``): the same for
  ``mlp_policy`` params trees over a plane-form env, through
  :func:`~evox_tpu_torch.kernels.rollout_mlp.fused_mlp_rollout`.

All draw the same initial states from one method, ``_episode_states``, so
their fitness agrees up to float rounding. The population is a flat
``(pop, dim)`` tensor or, for ``mlp_policy``, a params tree whose leaves
carry the population axis first.

The scan engine also runs the JAX package's host-side rollout helpers as
state threaded through ``evaluate``: :class:`CapEpisode`, an episode-length
cap at twice the measured mean episode length, and :class:`ObsNormalizer`,
running observation statistics (observations normalised with the stats at
the start of an evaluation, the moments of every live step merged after
it). :meth:`PolicyRolloutProblem.visualize` returns one policy's whole
:class:`Trajectory`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, check_device, resolve_device
from ...core.problem import Problem
from ...core.struct import PyTreeNode
from ...utils.common import (
    fold_in_seed,
    generator,
    split_seed,
    sqrt_rn,
    tree_flatten,
    tree_map,
)
from .control.envs import EnvSpec


class CapEpisode:
    """Adaptive episode-length cap: roll out at most twice the measured mean
    episode length. The state is a 0-d int32 tensor."""

    def __init__(self, init_cap: int = 100):
        self.init_cap = init_cap

    def init(self, device: DeviceLike = None) -> torch.Tensor:
        return torch.tensor(self.init_cap, dtype=torch.int32, device=resolve_device(device))

    def update(self, cap: torch.Tensor, episode_lengths: torch.Tensor) -> torch.Tensor:
        del cap  # the new cap depends only on the measured lengths
        mean = episode_lengths.to(torch.float32).mean()
        return torch.clamp_min((2.0 * mean).to(torch.int32), 1)

    def get(self, cap: torch.Tensor) -> torch.Tensor:
        return cap


class ObsNormalizer:
    """Running observation statistics; the state is ``(count, mean, m2)``:
    a 0-d float32 count and two ``(obs_dim,)`` float32 tensors."""

    def __init__(self, obs_dim: int, clip: float = 10.0):
        self.obs_dim = obs_dim
        self.clip = clip

    def init(self, device: DeviceLike = None):
        dev = resolve_device(device)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        return (zeros(), zeros(self.obs_dim), zeros(self.obs_dim))

    def update(self, state, obs_batch: torch.Tensor):
        """Welford batch update from a ``(..., obs_dim)`` batch of
        observations."""
        b = obs_batch.reshape(-1, self.obs_dim)
        count = torch.tensor(float(b.shape[0]), dtype=torch.float32, device=b.device)
        return self.merge_moments(state, count, b.sum(0), (b * b).sum(0))

    def merge_moments(self, state, cnt, s1, s2):
        """Merge raw moments (count, sum, sum of squares) into the running
        ``(count, mean, m2)`` state (Chan's parallel update)."""
        count, mean, m2 = state
        one = torch.ones((), dtype=count.dtype, device=count.device)
        safe_cnt = torch.maximum(cnt, one)
        b_mean = s1 / safe_cnt
        # clamp: the raw sum-of-squares form can cancel to small negatives
        # in float32 when |mean| >> stddev, which would NaN the sqrt later
        b_m2 = torch.maximum(s2 - safe_cnt * b_mean * b_mean, torch.zeros_like(s2))
        new_count = count + cnt
        delta = b_mean - mean
        seen = cnt > 0
        new_mean = torch.where(seen, mean + delta * cnt / torch.maximum(new_count, one), mean)
        new_m2 = torch.where(
            seen, m2 + b_m2 + delta * delta * count * cnt / torch.maximum(new_count, one), m2
        )
        return (new_count, new_mean, new_m2)

    def normalize(self, state, obs: torch.Tensor) -> torch.Tensor:
        count, mean, m2 = state
        one = torch.ones((), dtype=count.dtype, device=count.device)
        var = torch.where(
            count > 1, torch.maximum(m2, torch.zeros_like(m2)) / torch.maximum(count - 1, one), one
        )
        return torch.clamp((obs - mean) / sqrt_rn(var + 1e-8), -self.clip, self.clip)


class Trajectory(NamedTuple):
    """One rollout's whole trace (:meth:`PolicyRolloutProblem.visualize`),
    time-major with ``max_episode_length`` steps; steps after the episode's
    end are frozen (the state repeats, reward 0, done True)."""

    states: torch.Tensor  # (T, state_dim)
    obs: torch.Tensor  # (T, obs_dim)
    actions: torch.Tensor  # (T, act_dim)
    rewards: torch.Tensor  # (T,)
    dones: torch.Tensor  # (T,) bool: done before the step
    length: torch.Tensor  # () int32: the live steps


class RolloutState(PyTreeNode):
    # integer seed of the episode-reset stream; the cap (0-d int32) with a
    # CapEpisode, the (count, mean, m2) stats with an ObsNormalizer, else None
    seed: int
    cap: Any = None
    norm: Any = None


class PolicyRolloutProblem(Problem):
    """Evaluate a population of policies by environment rollouts.

    Args:
        policy: ``(params, obs) -> action``, broadcasting over leading batch
            dimensions (``apply`` from :func:`flat_mlp_policy` over flat
            genomes, or from :func:`mlp_policy` over params trees).
        env: an :class:`EnvSpec`.
        num_episodes: episodes per individual; fitness = ``reduce_fn`` over
            episode returns.
        max_episode_length: cap on environment steps (defaults to the env's).
        reduce_fn: ``reduce_fn(returns, dim=-1)``, default ``torch.mean``.
        stochastic_reset: draw fresh episode seeds every evaluation; False
            keeps one evaluation seed (lower-variance ES gradients).
        cap_episode: a :class:`CapEpisode` (scan engine): the episode-length
            cap adapts to the measured mean episode length across
            generations.
        obs_normalizer: an :class:`ObsNormalizer` (scan engine):
            observations are normalised before the policy sees them, and
            the running stats are updated from every live (not yet done)
            step of every rollout.
        early_exit: scan engine only — True stops once every episode is
            done, False always runs ``max_episode_length`` steps; the
            fitness is the same. False cannot be combined with
            ``cap_episode``.
        fused_env: an :class:`~evox_tpu_torch.kernels.rollout.SoAEnv` —
            evaluate through the fused rollout kernel. Requires a flat
            ``(pop, dim)`` population in ``flat_mlp_policy`` layout.
        fused_planes: a :class:`~evox_tpu_torch.kernels.rollout_mlp.PlaneEnv`
            — evaluate through the big-policy kernel. Requires an
            ``mlp_policy`` params tree as the population (a
            ``TreeAndVector`` adapter's ``batched_to_tree`` as the
            workflow's pop transform); the kernel reads its leaves in place.
        fused_planes_dtype: the big-policy kernel's residency dtype for the
            policy, ``None`` (float32) or ``torch.bfloat16`` (half the shared
            memory a block; accumulation and env math stay float32). Any
            other dtype raises.
        fused_planes_linear: layer indices with no tanh after them, as the
            policy's ``mlp_policy(linear_layers=...)``.
        device: ``None`` means ``"cuda"``.
    """

    def __init__(
        self,
        policy: Callable,
        env: EnvSpec,
        num_episodes: int = 4,
        max_episode_length: Optional[int] = None,
        reduce_fn: Callable = torch.mean,
        stochastic_reset: bool = True,
        cap_episode: Any = None,
        obs_normalizer: Any = None,
        early_exit: bool = True,
        fused_env: Any = None,
        fused_planes: Any = None,
        fused_planes_dtype: Any = None,
        fused_planes_linear: Tuple[int, ...] = (),
        device: DeviceLike = None,
    ):
        if not early_exit and cap_episode is not None:
            raise ValueError("early_exit=False cannot be combined with cap_episode")
        if fused_env is not None and fused_planes is not None:
            raise ValueError("pass fused_env OR fused_planes, not both")
        if (fused_env is not None or fused_planes is not None) and (
            cap_episode is not None or obs_normalizer is not None
        ):
            raise ValueError(
                "fused_env and fused_planes cannot be combined with cap_episode or "
                "obs_normalizer"
            )
        from ...kernels.rollout_mlp import residency_bytes

        residency_bytes(fused_planes_dtype)
        self.device = resolve_device(device)
        self.policy = policy
        self.env = env
        self.num_episodes = num_episodes
        self.max_len = max_episode_length or env.max_steps
        self.reduce_fn = reduce_fn
        self.stochastic_reset = stochastic_reset
        self.cap_episode = cap_episode
        self.obs_normalizer = obs_normalizer
        self.early_exit = early_exit
        if fused_env is not None:
            self._check_fused_base(fused_env.base, "fused_env")
        if fused_planes is not None:
            self._check_fused_base(fused_planes.base, "fused_planes")
        self.fused_env = fused_env
        self.fused_planes = fused_planes
        self.fused_planes_dtype = fused_planes_dtype
        self.fused_planes_linear = tuple(int(i) for i in fused_planes_linear)
        self._fused_policy_checked = False

    def _check_fused_base(self, base: EnvSpec, name: str) -> None:
        """A fused spec over a *different* env than ``env`` would evaluate a
        different workload than the scan engine — refuse it up front."""
        if base is self.env:
            return
        for attr in ("obs_dim", "act_dim", "max_steps"):
            if getattr(base, attr) != getattr(self.env, attr):
                raise ValueError(
                    f"{name}.base disagrees with env on {attr!r} "
                    f"({getattr(base, attr)} vs {getattr(self.env, attr)}); "
                    "build the fused spec over the same EnvSpec passed as env"
                )

    def _check_fused_policy(self, dim: int, hidden: int) -> None:
        """One-time probe on the CPU: ``self.policy`` must agree with the
        kernel's flat-MLP math, else evolution would optimize a different
        network than the ``policy`` the user later deploys."""
        from ...kernels.rollout import _mlp_act

        obs_dim, act_dim = self.env.obs_dim, self.env.act_dim
        rng = np.random.default_rng(0)
        theta = torch.as_tensor(rng.normal(size=(dim,)), dtype=torch.float32)
        obs = torch.as_tensor(rng.normal(size=(obs_dim,)), dtype=torch.float32)
        want = torch.cat(
            _mlp_act(
                theta[:, None], tuple(obs[k : k + 1] for k in range(obs_dim)),
                obs_dim, hidden, act_dim,
            )
        )
        got = torch.as_tensor(self.policy(theta, obs)).reshape(-1)
        if got.shape != want.shape or not torch.allclose(got, want, atol=1e-5):
            raise ValueError(
                "fused_env requires the policy to be the flat tanh MLP the "
                "kernel implements (use flat_mlp_policy); the supplied "
                "policy disagrees with the kernel math on a probe input"
            )
        self._fused_policy_checked = True

    def _check_fused_planes_policy(self, sizes: Tuple[int, ...]) -> None:
        """One-time probe on the CPU: ``self.policy`` must agree with the
        big-policy kernel's tanh-MLP plane math on the params tree layout."""
        from ...kernels.rollout_mlp import _mlp_planes

        rng = np.random.default_rng(0)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32)
        params = [
            {"w": as_t(rng.normal(size=(fi, fo)) * 0.3), "b": as_t(rng.normal(size=(fo,)))}
            for fi, fo in zip(sizes[:-1], sizes[1:])
        ]
        obs = as_t(rng.normal(size=(sizes[0],)))
        want = _mlp_planes(
            [l["w"][:, :, None] for l in params], [l["b"][:, None] for l in params],
            obs[:, None], sizes, self.fused_planes_linear,
        ).reshape(-1)
        got = torch.as_tensor(self.policy(params, obs)).reshape(-1)
        if got.shape != want.shape or not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
            raise ValueError(
                "fused_planes requires the policy to be the tanh MLP the "
                "kernel implements (use mlp_policy); the supplied policy "
                "disagrees with the kernel math on a probe input"
            )
        self._fused_policy_checked = True

    def init(self, seed: Optional[int] = None) -> RolloutState:
        return RolloutState(
            seed=0 if seed is None else seed,
            cap=self.cap_episode.init(self.device) if self.cap_episode else None,
            norm=self.obs_normalizer.init(self.device) if self.obs_normalizer else None,
        )

    def _episode_seed(self, state: RolloutState) -> Tuple[int, int]:
        """(next state seed, this evaluation's episode seed)."""
        if self.stochastic_reset:
            seed, ep_seed = split_seed(state.seed)
            return seed, ep_seed
        return state.seed, fold_in_seed(state.seed, 0)

    def _episode_states(self, seed: int, env: EnvSpec) -> torch.Tensor:
        """``(num_episodes, state_dim)`` initial states, one per episode,
        shared by the whole population (common random numbers). The one
        place the engines draw resets."""
        return env.reset(generator(seed, self.device), self.num_episodes, self.device)

    def fused_inputs(self, state: RolloutState, pop: torch.Tensor) -> dict:
        """The keyword arguments the fused engine hands
        :func:`~evox_tpu_torch.kernels.rollout.fused_rollout` when it
        evaluates ``pop`` from ``state``."""
        _, ep_seed = self._episode_seed(state)
        pop_size, dim = pop.shape
        ep = self.num_episodes
        obs_dim, act_dim = self.env.obs_dim, self.env.act_dim
        hidden, rem = divmod(dim - act_dim, obs_dim + 1 + act_dim)
        if rem:
            raise ValueError(
                f"population dim {dim} is not a flat_mlp_policy genome for "
                f"obs_dim={obs_dim}, act_dim={act_dim}"
            )
        if not self._fused_policy_checked:
            self._check_fused_policy(dim, hidden)

        # (ep, state_dim) resets -> (ep * pop, state_dim), EPISODE-MAJOR, so
        # the kernel maps env e*pop + i to genome i with no repeated theta
        env_state0 = self._episode_states(ep_seed, self.fused_env.base)
        env_flat = env_state0[:, None, :].expand(ep, pop_size, env_state0.shape[-1])
        soa0 = {
            k: v.contiguous()
            for k, v in self.fused_env.to_soa(env_flat.reshape(ep * pop_size, -1)).items()
        }
        return dict(
            theta=pop,
            init_state=soa0,
            T=int(self.max_len),
            obs_dim=obs_dim,
            hidden=hidden,
            act_dim=act_dim,
            env=self.fused_env,
            episodes=ep,
            device=self.device,
        )

    def _evaluate_fused(
        self, state: RolloutState, pop: torch.Tensor
    ) -> Tuple[torch.Tensor, RolloutState]:
        """Fused-kernel engine: same seed/reset/reduce semantics as the scan
        engine, the episode loop inside one kernel launch."""
        from ...kernels.rollout import fused_rollout

        seed, _ = self._episode_seed(state)
        totals = fused_rollout(**self.fused_inputs(state, pop))
        # (ep, pop) episode-major -> (pop, ep) so reduce_fn sees the same
        # axis convention as the scan engine
        fitness = self.reduce_fn(totals.reshape(self.num_episodes, pop.shape[0]).T, dim=-1)
        return fitness, state.replace(seed=seed)

    def fused_planes_inputs(self, state: RolloutState, pop: Any) -> dict:
        """The keyword arguments the big-policy engine hands
        :func:`~evox_tpu_torch.kernels.rollout_mlp.fused_mlp_rollout` when it
        evaluates the ``mlp_policy`` params tree ``pop`` from ``state``:
        weight planes ``(fan_in, fan_out, pop)`` and bias planes ``(fan_out,
        pop)`` as views of the tree's leaves (no copy), and the episode
        resets as planes."""
        if not (
            isinstance(pop, (list, tuple))
            and all(isinstance(l, dict) and {"w", "b"} <= set(l) for l in pop)
        ):
            raise ValueError(
                "fused_planes expects an mlp_policy params tree "
                "(list of {'w', 'b'} layers)"
            )
        weights = tuple(l["w"].permute(1, 2, 0) for l in pop)  # (in, out, n)
        biases = tuple(l["b"].T for l in pop)  # (out, n)
        sizes = (weights[0].shape[0],) + tuple(w.shape[1] for w in weights)
        if sizes[0] != self.env.obs_dim or sizes[-1] != self.env.act_dim:
            raise ValueError(
                f"policy sizes {sizes} do not match env "
                f"({self.env.obs_dim} -> {self.env.act_dim})"
            )
        if not self._fused_policy_checked:
            self._check_fused_planes_policy(sizes)
        _, ep_seed = self._episode_seed(state)
        pop_size, ep = pop[0]["b"].shape[0], self.num_episodes
        env_state0 = self._episode_states(ep_seed, self.fused_planes.base)
        env_flat = env_state0[:, None, :].expand(ep, pop_size, env_state0.shape[-1])
        return dict(
            weights=weights,
            biases=biases,
            init_state=self.fused_planes.to_planes(env_flat.reshape(ep * pop_size, -1)),
            T=int(self.max_len),
            sizes=sizes,
            env=self.fused_planes,
            episodes=ep,
            linear=self.fused_planes_linear,
            weight_dtype=self.fused_planes_dtype,
            device=self.device,
        )

    def _evaluate_fused_planes(
        self, state: RolloutState, pop: Any
    ) -> Tuple[torch.Tensor, RolloutState]:
        """Big-policy kernel engine: same seed/reset/reduce semantics as the
        scan engine, each env's episode in one block of one launch."""
        from ...kernels.rollout_mlp import fused_mlp_rollout

        seed, _ = self._episode_seed(state)
        totals = fused_mlp_rollout(**self.fused_planes_inputs(state, pop))
        pop_size = pop[0]["b"].shape[0]
        fitness = self.reduce_fn(totals.reshape(self.num_episodes, pop_size).T, dim=-1)
        return fitness, state.replace(seed=seed)

    def evaluate(self, state: RolloutState, pop: Any) -> Tuple[torch.Tensor, RolloutState]:
        leaves, _ = tree_flatten(pop)
        for leaf in leaves:
            check_device(leaf, self.device, "population")
        if self.fused_planes is not None:
            return self._evaluate_fused_planes(state, pop)
        if self.fused_env is not None:
            return self._evaluate_fused(state, pop)
        seed, ep_seed = self._episode_seed(state)
        pop_size = leaves[0].shape[0]
        ep = self.num_episodes
        env_state0 = self._episode_states(ep_seed, self.env)  # (ep, state_dim)
        env_state = env_state0.expand((pop_size,) + env_state0.shape)  # (pop, ep, sd)
        # broadcasts over the episode axis; a params tree leaf by leaf
        params = tree_map(lambda x: x[:, None], pop)
        max_len = int(self.max_len)
        if self.cap_episode is not None:
            max_len = min(max_len, int(self.cap_episode.get(state.cap)))
        norm = self.obs_normalizer

        done = torch.zeros((pop_size, ep), dtype=torch.bool, device=self.device)
        total = torch.zeros((pop_size, ep), dtype=torch.float32, device=self.device)
        ep_len = torch.zeros((pop_size, ep), dtype=torch.int32, device=self.device)
        # the moments of the live steps' observations: count, sum, sum of squares
        cnt = torch.zeros((), dtype=torch.float32, device=self.device)
        s1 = torch.zeros(self.env.obs_dim, dtype=torch.float32, device=self.device)
        s2 = torch.zeros_like(s1)
        for _ in range(max_len):
            if self.early_exit and bool(done.all()):
                break
            o = self.env.obs(env_state)
            if norm is not None:
                live = (~done).to(o.dtype)[..., None]  # (pop, ep, 1)
                cnt = cnt + live.sum()
                s1 = s1 + (o * live).sum((0, 1))
                s2 = s2 + (o * o * live).sum((0, 1))
                o = norm.normalize(state.norm, o)
            actions = self.policy(params, o)
            new_state, reward, step_done = self.env.step(env_state, actions)
            total = total + torch.where(done, torch.zeros_like(reward), reward)
            ep_len = ep_len + (~done).to(torch.int32)
            # freeze finished episodes' states so the loop is a no-op there
            env_state = torch.where(done[..., None], env_state, new_state)
            done = done | step_done
        fitness = self.reduce_fn(total, dim=-1)
        cap, stats = state.cap, state.norm
        if self.cap_episode is not None:
            cap = self.cap_episode.update(cap, ep_len)
        if norm is not None:
            stats = norm.merge_moments(stats, cnt, s1, s2)
        return fitness, RolloutState(seed=seed, cap=cap, norm=stats)

    def visualize(
        self, params: Any, seed: Optional[int] = None, state: Optional[RolloutState] = None
    ) -> Trajectory:
        """Roll out ONE policy for ``max_episode_length`` steps and return its
        whole :class:`Trajectory`: the env states, observations, actions,
        rewards and done flags of every step, and the live steps. ``seed``
        draws the initial state (default 0); with an :class:`ObsNormalizer`,
        the policy sees the observations normalised with ``state.norm``
        (pass the problem state after training to see what it saw)."""
        env_state = self.env.reset(generator(0 if seed is None else seed, self.device), 1,
                                   self.device)[0]
        done = torch.zeros((), dtype=torch.bool, device=self.device)
        trace = []
        for _ in range(int(self.max_len)):
            o = self.env.obs(env_state)
            o_in = (
                self.obs_normalizer.normalize(state.norm, o)
                if self.obs_normalizer is not None and state is not None
                else o
            )
            action = self.policy(params, o_in)
            new_state, reward, step_done = self.env.step(env_state, action)
            trace.append((env_state, o, action, torch.where(done, 0.0, reward), done))
            env_state = torch.where(done, env_state, new_state)
            done = done | step_done
        states, obs, actions, rewards, dones = (torch.stack(x) for x in zip(*trace))
        return Trajectory(states=states, obs=obs, actions=actions, rewards=rewards, dones=dones,
                          length=(~dones).sum().to(torch.int32))
