"""Host environment problems — the port of
``evox_tpu/problems/neuroevolution/hostenv.py``.

An external simulator steps on the host, one env per individual (the
EnvPool contract), while the policy of the whole population runs on the
problem's device. The JAX package runs the episode as a ``while_loop`` over
two ordered ``io_callback``\\ s; the port runs it as a Python loop: each
step copies the observations host to device and the actions device to
host through the problem's ``HostLink`` (pinned blocks on a card, the
copies counted and timed).

``NumpyCartPoleVec`` is a vectorized host env in numpy (CartPole-v1
dynamics) with no dependency; ``envpool_make`` wraps EnvPool when that
package is installed.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Protocol, Tuple

import numpy as np
import torch

from ...core.device import DeviceLike, resolve_device
from ...core.problem import Problem
from ...utils.common import split_seed
from ...workflows.common import HostLink, host_candidates


class HostVectorEnv(Protocol):
    """Batched host environment: ``num_envs`` parallel episodes."""

    num_envs: int
    obs_dim: int

    def reset(self, seed: int) -> np.ndarray:  # (num_envs, obs_dim)
        ...

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """-> (obs, reward, terminated, truncated), each (num_envs, ...)."""
        ...


class NumpyCartPoleVec:
    """Vectorized CartPole-v1 in numpy (standard Gym dynamics). Envs that
    are done freeze (their state, reward 0), as EnvPool's do by default."""

    obs_dim = 4
    act_dim = 2

    def __init__(self, num_envs: int, max_steps: int = 500):
        self.num_envs = num_envs
        self.max_steps = max_steps
        self._s = np.zeros((num_envs, 4))
        self._done = np.zeros((num_envs,), dtype=bool)
        self._t = 0

    def reset(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(int(seed))
        self._s = rng.uniform(-0.05, 0.05, size=(self.num_envs, 4))
        self._done[:] = False
        self._t = 0
        return self._s.astype(np.float32)

    def step(self, actions: np.ndarray):
        force = np.where(actions[:, 1] > actions[:, 0], 10.0, -10.0)
        x, x_dot, th, th_dot = self._s.T
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + 0.05 * th_dot**2 * sin) / 1.1
        thacc = (9.8 * sin - cos * temp) / (0.5 * (4.0 / 3.0 - 0.1 * cos**2 / 1.1))
        xacc = temp - 0.05 * thacc * cos / 1.1
        new = np.stack(
            [x + 0.02 * x_dot, x_dot + 0.02 * xacc, th + 0.02 * th_dot, th_dot + 0.02 * thacc],
            axis=1,
        )
        live = ~self._done
        self._s = np.where(live[:, None], new, self._s)
        self._t += 1
        reward = live.astype(np.float32)
        terminated = (np.abs(self._s[:, 0]) > 2.4) | (np.abs(self._s[:, 2]) > 0.2095)
        truncated = np.full((self.num_envs,), self._t >= self.max_steps)
        self._done |= terminated | truncated
        return self._s.astype(np.float32), reward, terminated, truncated


class EnvPoolAdapter:
    """An EnvPool gymnasium-API batch env as a :class:`HostVectorEnv`.

    EnvPool's ``reset()`` gives ``(obs, info)`` and ``step()`` ``(obs,
    reward, terminated, truncated, info)``; the adapter drops the infos.
    EnvPool fixes its RNG seed at construction, so the per-evaluation
    ``seed`` only triggers a reset; pass ``seed`` through ``env_options``
    for a chosen stream.

    ``action_transform`` maps the policy's raw ``(num_envs, act_dim)``
    output to what the env expects, e.g. ``lambda a: a.argmax(-1)`` for a
    discrete action space.
    """

    def __init__(self, env, num_envs: int, action_transform=None):
        self._env = env
        self._action_transform = action_transform
        self.num_envs = num_envs
        self.obs_dim = int(np.prod(env.observation_space.shape))
        self._warned_seed = False

    def reset(self, seed: int) -> np.ndarray:
        if not self._warned_seed:
            self._warned_seed = True
            warnings.warn(
                "EnvPoolAdapter ignores the per-evaluation seed (EnvPool "
                "fixes its RNG at construction): every generation replays "
                "the same episode stream. Pass seed= through env_options "
                "at envpool_make() for a chosen stream.",
                stacklevel=2,
            )
        obs, _info = self._env.reset()
        return np.asarray(obs, dtype=np.float32).reshape(self.num_envs, -1)

    def step(self, actions: np.ndarray):
        if self._action_transform is not None:
            actions = self._action_transform(actions)
        obs, reward, terminated, truncated, _info = self._env.step(actions)
        return (
            np.asarray(obs, dtype=np.float32).reshape(self.num_envs, -1),
            np.asarray(reward, dtype=np.float32),
            np.asarray(terminated, dtype=bool),
            np.asarray(truncated, dtype=bool),
        )


def envpool_make(env_name: str, num_envs: int, action_transform: Optional[Callable] = None,
                 **env_options) -> HostVectorEnv:
    """An EnvPool env (an optional dependency) as a :class:`HostVectorEnv`.

    EnvPool fixes its RNG at construction, so per-evaluation seeds are
    ignored (a warning on the first reset); pass ``seed=`` here through
    ``env_options`` to pick the episode stream."""
    try:
        import envpool
    except ImportError as e:
        raise ImportError(
            "envpool is not installed; use NumpyCartPoleVec or another "
            "HostVectorEnv implementation"
        ) from e
    env = envpool.make(env_name, num_envs=num_envs, env_type="gymnasium", **env_options)
    return EnvPoolAdapter(env, num_envs, action_transform)


class HostEnvProblem(Problem):
    """Score a population by stepping a :class:`HostVectorEnv`, one env per
    individual, with the policy on the problem's device.

    Args:
        policy: ``(params, obs) -> action`` for one individual (vmapped
            over the population with ``torch.func.vmap``).
        env: the host vector env; ``env.num_envs`` must equal the
            population size.
        cap_episode_length: hard step cap (None = run until all are done).
        device: where the policy runs; ``None`` means ``"cuda"``.

    The state is an integer seed. Each evaluation draws the env's reset
    seed from it through :meth:`_episode_seed`, the one draw a test
    replaces. The done mask, the step cap and the float32 return sum stay
    on the host, where their inputs arrive; the return crosses to the
    device once, at the end. Every copy goes through ``host_link``, whose
    ``report()`` gives the copies, their bytes and their device times.
    """

    def __init__(self, policy: Callable, env: HostVectorEnv,
                 cap_episode_length: Optional[int] = None, device: DeviceLike = None):
        self.policy = policy
        self.env = env
        self.num_envs = env.num_envs
        self.cap = cap_episode_length
        self.device = resolve_device(device)
        self.batched_policy = torch.func.vmap(policy)
        self.host_link = HostLink(self.device)

    def init(self, seed: Optional[int] = None) -> int:
        return 0 if seed is None else seed

    def _episode_seed(self, state: int) -> Tuple[int, int]:
        """(this evaluation's env reset seed in ``[0, 2**31 - 1)``, the
        next state)."""
        carry, use = split_seed(state)
        return use % (2**31 - 1), carry

    def evaluate(self, state: int, pop) -> Tuple[torch.Tensor, int]:
        seed, state = self._episode_seed(state)
        ob = np.asarray(self.env.reset(int(seed)), dtype=np.float32)
        done = np.zeros((self.num_envs,), dtype=bool)
        total = np.zeros((self.num_envs,), dtype=np.float32)
        zero = np.float32(0.0)
        i = 0
        while not done.all() and (self.cap is None or i < self.cap):
            actions = self.batched_policy(pop, self.host_link.to_device(ob))
            ob, reward, term, trunc = self.env.step(host_candidates(self.host_link, actions))
            ob = np.asarray(ob, dtype=np.float32)  # the reference's cast, on the host
            total = total + np.where(done, zero, np.asarray(reward, dtype=np.float32))
            done = done | np.asarray(term, dtype=bool) | np.asarray(trunc, dtype=bool)
            i += 1
        return self.host_link.to_device(total), state
