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
carry the population axis first. The JAX package's
``CapEpisode``/``ObsNormalizer`` and bf16 policy residency
(``fused_planes_dtype``) wait (ROADMAP A4, B2); passing them raises.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, check_device, resolve_device
from ...core.problem import Problem
from ...core.struct import PyTreeNode
from ...utils.common import fold_in_seed, generator, split_seed, tree_flatten, tree_map
from .control.envs import EnvSpec


class RolloutState(PyTreeNode):
    # integer seed of the episode-reset stream; the JAX state's cap and
    # norm leaves come with CapEpisode / ObsNormalizer
    seed: int


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
        early_exit: scan engine only — True stops once every episode is
            done, False always runs ``max_episode_length`` steps; the
            fitness is the same.
        fused_env: an :class:`~evox_tpu_torch.kernels.rollout.SoAEnv` —
            evaluate through the fused rollout kernel. Requires a flat
            ``(pop, dim)`` population in ``flat_mlp_policy`` layout.
        fused_planes: a :class:`~evox_tpu_torch.kernels.rollout_mlp.PlaneEnv`
            — evaluate through the big-policy kernel. Requires an
            ``mlp_policy`` params tree as the population (a
            ``TreeAndVector`` adapter's ``batched_to_tree`` as the
            workflow's pop transform); the kernel reads its leaves in place.
        fused_planes_dtype: bf16 policy residency; not ported yet, anything
            but None raises.
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
        if cap_episode is not None or obs_normalizer is not None:
            raise NotImplementedError(
                "cap_episode and obs_normalizer are not ported yet (ROADMAP A4)"
            )
        if fused_planes_dtype is not None:
            raise NotImplementedError(
                "fused_planes_dtype (bf16 policy residency) is not ported yet (ROADMAP B2)"
            )
        if fused_env is not None and fused_planes is not None:
            raise ValueError("pass fused_env OR fused_planes, not both")
        self.device = resolve_device(device)
        self.policy = policy
        self.env = env
        self.num_episodes = num_episodes
        self.max_len = max_episode_length or env.max_steps
        self.reduce_fn = reduce_fn
        self.stochastic_reset = stochastic_reset
        self.early_exit = early_exit
        if fused_env is not None:
            self._check_fused_base(fused_env.base, "fused_env")
        if fused_planes is not None:
            self._check_fused_base(fused_planes.base, "fused_planes")
        self.fused_env = fused_env
        self.fused_planes = fused_planes
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
        return RolloutState(seed=0 if seed is None else seed)

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
        return fitness, RolloutState(seed=seed)

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
        return fitness, RolloutState(seed=seed)

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

        done = torch.zeros((pop_size, ep), dtype=torch.bool, device=self.device)
        total = torch.zeros((pop_size, ep), dtype=torch.float32, device=self.device)
        for _ in range(int(self.max_len)):
            if self.early_exit and bool(done.all()):
                break
            actions = self.policy(params, self.env.obs(env_state))
            new_state, reward, step_done = self.env.step(env_state, actions)
            total = total + torch.where(done, torch.zeros_like(reward), reward)
            # freeze finished episodes' states so the loop is a no-op there
            env_state = torch.where(done[..., None], env_state, new_state)
            done = done | step_done
        fitness = self.reduce_fn(total, dim=-1)
        return fitness, RolloutState(seed=seed)
