"""Host rollout farm — the port of
``evox_tpu/problems/neuroevolution/rollout_farm.py``: episode parallelism on
the host for simulators with a Python ``reset``/``step`` API (gymnasium
style) that do not run on the card.

A thread pool of workers, each owning a slice of the environments, in one
of two policy placements:

- ``batch_policy=True`` (the default): every step gathers the observations
  of all workers, runs ONE vmapped policy forward for the whole population
  on the farm's device, and scatters the actions back to the workers. Only
  observations and actions cross between host and device.
- ``batch_policy=False``: each worker loops its own episodes to completion
  with the vmapped policy on the farm's device, with no global lockstep:
  better when episode lengths vary widely and the policy is tiny. Each
  worker moves only its own slice's observations and actions, on the
  default stream: a stream a worker was measured no faster on the card,
  where the interpreter lock sets the time (the JAX package runs this
  placement's ``jax.jit(jax.vmap(policy))`` on the default accelerator).
  On the CPU it is the placement of :class:`~evox_tpu_torch.problems.
  neuroevolution.process_farm.ProcessRolloutFarm`'s workers, whose fitness
  it equals bit for bit.

Threads suffice: env ``step`` bodies are numpy or C code that releases the
interpreter lock, and so do PyTorch's operators.

Objectives from the env ``info`` dict through ``mo_keys``; an episode cap
that adapts to the measured episode lengths through ``adaptive_cap``.

This problem runs on the host (``jittable = False``): a workflow hands it
numpy candidates and takes numpy fitness back.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device
from ...core.problem import Problem
from ...utils.common import tree_flatten, tree_map


def _as_numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _as_tensor(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x)).to(device)


class _Worker:
    """Owns a slice of environments and their episode bookkeeping."""

    def __init__(self, env_creator: Callable, mo_keys: Sequence[str]):
        self.env_creator = env_creator
        self.mo_keys = tuple(mo_keys)
        self.envs: list = []

    def reset(self, seed: int, num_env: int) -> np.ndarray:
        while len(self.envs) < num_env:
            self.envs.append(self.env_creator())
        self.n = num_env
        self.total_rewards = np.zeros((num_env,))
        self.acc_mo = np.zeros((num_env, len(self.mo_keys)))
        self.episode_length = np.zeros((num_env,))
        self.done = np.zeros((num_env,), dtype=bool)
        obs, self.infos = zip(
            *[env.reset(seed=seed + i) for i, env in enumerate(self.envs[:num_env])]
        )
        self.observations = list(obs)
        return np.stack(self.observations)

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, bool]:
        for i, env in enumerate(self.envs[: self.n]):
            if self.done[i]:
                continue
            obs, reward, terminated, truncated, info = env.step(actions[i])
            self.observations[i] = obs
            self.total_rewards[i] += reward
            self.episode_length[i] += 1
            self.done[i] = terminated or truncated
            for j, k in enumerate(self.mo_keys):
                if k not in info:
                    raise KeyError(
                        f"mo_keys has {k!r}, not in env info "
                        f"(available: {list(info.keys())})"
                    )
                self.acc_mo[i, j] += info[k]
        return np.stack(self.observations), bool(self.done.all())

    def rollout(self, policy_fn: Callable, subpop: Any, seed: int, cap: Optional[int],
                device: torch.device = torch.device("cpu")) -> None:
        """Independent episode loop with the policy on ``device``
        (``batch_policy=False``; the process farm's workers keep the CPU)."""
        self.reset(seed, _tree_batch_size(subpop))
        params = tree_map(lambda x: _as_tensor(x, device), subpop)
        steps = 0
        while not self.done.all():
            obs = torch.from_numpy(np.stack(self.observations).astype(np.float32, copy=False))
            self.step(policy_fn(params, obs.to(device)).cpu().numpy())
            steps += 1
            if cap is not None and steps >= cap:
                break

    def results(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.total_rewards, self.acc_mo, self.episode_length


def _tree_batch_size(tree: Any) -> int:
    return tree_flatten(tree)[0][0].shape[0]


def _tree_split(tree: Any, n: int) -> list:
    """Split every leaf's leading axis into ``n`` near-even chunks
    (``np.array_split``), as a list of sub-trees."""
    leaves, rebuild = tree_flatten(tree)
    chunks = [np.array_split(_as_numpy(leaf), n, axis=0) for leaf in leaves]
    return [rebuild([c[i] for c in chunks]) for i in range(n)]


class HostRolloutFarm(Problem):
    """Roll out a population on host environments over a thread pool.

    Args:
        policy: ``(params, obs) -> action`` for one individual, in PyTorch
            (vmapped with ``torch.func.vmap``).
        env_creator: zero-argument callable building one gymnasium-API env.
        num_workers: worker threads, each owning a slice of the population.
        mo_keys: env-info keys accumulated as objectives.
        batch_policy: the lockstep placement or the per-worker one, both
            with the policy on ``device``; see the module docstring.
        cap_episode: step cap of an episode (None = until done).
        adaptive_cap: after each evaluation, set the cap to twice the mean
            measured episode length.
        device: where the policy runs, in either placement; ``None``
            means ``"cuda"``.

    Episode seeds come from the farm's own host generator ``_seed_rng``
    (unseeded, as in the JAX package): a workflow keeps no state for a
    host problem, so the variation between generations lives here. A test
    injects the same generator into both packages.
    """

    jittable = False

    def __init__(
        self,
        policy: Callable,
        env_creator: Callable,
        num_workers: int = 4,
        mo_keys: Sequence[str] = (),
        batch_policy: bool = True,
        cap_episode: Optional[int] = None,
        adaptive_cap: bool = False,
        device: DeviceLike = None,
    ):
        self.policy = policy
        self.batched_policy = torch.func.vmap(policy)
        self.num_workers = num_workers
        self.mo_keys = tuple(mo_keys)
        self.batch_policy = batch_policy
        self.cap = cap_episode
        self.adaptive_cap = adaptive_cap
        self.device = resolve_device(device)
        self.workers = [_Worker(env_creator, mo_keys) for _ in range(num_workers)]
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self._seed_rng = np.random.default_rng()

    def fit_shape(self, pop_size: int) -> Tuple[int, ...]:
        if self.mo_keys:
            return (pop_size, len(self.mo_keys))
        return (pop_size,)

    def evaluate(self, state, pop):
        seed = int(self._seed_rng.integers(0, np.iinfo(np.int32).max))
        pop = tree_map(_as_numpy, pop)
        pop_size = _tree_batch_size(pop)
        n_active = min(self.num_workers, pop_size)  # never hand a worker 0 envs
        workers = self.workers[:n_active]
        subpops = _tree_split(pop, n_active)
        sizes = [_tree_batch_size(s) for s in subpops]

        if self.batch_policy:
            rewards, mo, lengths = self._lockstep(pop, workers, sizes, seed)
        else:
            futures = [
                self.pool.submit(w.rollout, self.batched_policy, sp, seed + 7919 * i, self.cap,
                                 self.device)
                for i, (w, sp) in enumerate(zip(workers, subpops))
            ]
            for f in futures:
                f.result()
            rewards, mo, lengths = self._gather(workers)

        if self.adaptive_cap:
            # the next generation's cap: twice the measured mean episode length
            self.cap = max(int(2.0 * float(np.mean(lengths))), 1)

        if self.mo_keys:
            return np.asarray(mo, dtype=np.float32), state
        return np.asarray(rewards, dtype=np.float32), state

    def _lockstep(self, pop, workers, sizes, seed):
        params = tree_map(lambda x: _as_tensor(x, self.device), pop)
        obs = list(
            self.pool.map(lambda wi: workers[wi[0]].reset(seed + 7919 * wi[0], wi[1]),
                          enumerate(sizes))
        )
        steps = 0
        while True:
            all_obs = torch.from_numpy(np.concatenate(obs, axis=0).astype(np.float32, copy=False))
            actions = self.batched_policy(params, all_obs.to(self.device)).cpu().numpy()
            action_slices = np.split(actions, np.cumsum(sizes)[:-1], axis=0)
            outs = list(self.pool.map(lambda wa: wa[0].step(wa[1]), zip(workers, action_slices)))
            obs = [o for o, _ in outs]
            steps += 1
            if all(done for _, done in outs):
                break
            if self.cap is not None and steps >= self.cap:
                break
        return self._gather(workers)

    def _gather(self, workers):
        rewards, mo, lengths = zip(*[w.results() for w in workers])
        return np.concatenate(rewards), np.concatenate(mo), np.concatenate(lengths)

    def visualize(
        self,
        params: Any,
        seed: int = 0,
        max_steps: Optional[int] = None,
        env_creator: Optional[Callable] = None,
        render: bool = True,
    ) -> Tuple[list, np.ndarray]:
        """Roll out ONE policy (on the farm's device) and collect the env's
        rendered frames: ``(frames, rewards)``. With ``render=False``, or
        an env whose ``render`` returns None, the frames are the raw
        observations. ``env_creator`` replaces the farm's own (one that
        sets ``render_mode="rgb_array"`` where the training envs are
        headless)."""
        env = (env_creator or self.workers[0].env_creator)()
        params = tree_map(lambda x: _as_tensor(_as_numpy(x), self.device), params)
        obs, _ = env.reset(seed=seed)
        frames: list = []
        rewards: list = []
        cap = max_steps if max_steps is not None else (self.cap or 10_000)
        can_render = render and hasattr(env, "render")
        for _ in range(cap):
            frame = env.render() if can_render else None
            frames.append(np.asarray(frame) if frame is not None else np.asarray(obs))
            action = self.policy(params, _as_tensor(np.asarray(obs, dtype=np.float32),
                                                    self.device)).cpu().numpy()
            obs, reward, terminated, truncated, _ = env.step(action)
            rewards.append(float(reward))
            if terminated or truncated:
                break
        return frames, np.asarray(rewards)
