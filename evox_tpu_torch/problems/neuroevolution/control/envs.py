"""Classic-control environments in PyTorch — the port of
``evox_tpu/problems/neuroevolution/control/envs.py`` (pendulum, cartpole).

The JAX package writes each env for one instance and vmaps it; here the
batch dimensions are written out: ``obs`` and ``step`` take a state of
shape ``(..., state_dim)`` and an action ``(..., act_dim)`` and work over
any leading dimensions, and ``reset(generator, n, device)`` draws ``n``
initial states at once. Dynamics follow the standard OpenAI-Gym
formulations (CartPole-v1, Pendulum-v1). Mountain car and acrobot wait
(ROADMAP A4).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class EnvSpec(NamedTuple):
    reset: Callable  # (generator, n, device) -> state (n, state_dim)
    obs: Callable  # (state (..., state_dim)) -> observation (..., obs_dim)
    step: Callable  # (state, action) -> (state, reward (...), done (...) bool)
    obs_dim: int
    act_dim: int
    discrete: bool
    max_steps: int


def _uniform(
    generator: torch.Generator, shape, lo: float, hi: float, device: torch.device
) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


# --------------------------------------------------------------------- cartpole

def cartpole(max_steps: int = 500) -> EnvSpec:
    gravity, masscart, masspole = 9.8, 1.0, 0.1
    total_mass = masscart + masspole
    length = 0.5
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_limit = 12 * 2 * math.pi / 360
    x_limit = 2.4

    def reset(generator, n, device):
        return _uniform(generator, (n, 4), -0.05, 0.05, device)

    def obs(s):
        return s

    def step(s, action):
        # action: logits (..., 2) -> force direction
        force = torch.where(action[..., 1] > action[..., 0], force_mag, -force_mag)
        x, x_dot, theta, theta_dot = s.unbind(-1)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        theta = theta + tau * theta_dot
        theta_dot = theta_dot + tau * thetaacc
        s = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        done = (torch.abs(x) > x_limit) | (torch.abs(theta) > theta_limit)
        return s, torch.ones_like(x), done

    return EnvSpec(reset, obs, step, 4, 2, True, max_steps)


# --------------------------------------------------------------------- pendulum

def pendulum(max_steps: int = 200) -> EnvSpec:
    max_speed, max_torque = 8.0, 2.0
    dt, g, m, l = 0.05, 10.0, 1.0, 1.0

    def reset(generator, n, device):
        theta = _uniform(generator, (n,), -math.pi, math.pi, device)
        theta_dot = _uniform(generator, (n,), -1.0, 1.0, device)
        return torch.stack([theta, theta_dot], dim=-1)

    def obs(s):
        return torch.stack([torch.cos(s[..., 0]), torch.sin(s[..., 0]), s[..., 1]], dim=-1)

    def step(s, action):
        theta, theta_dot = s[..., 0], s[..., 1]
        u = torch.clamp(action[..., 0], -max_torque, max_torque)
        # floored modulo, like jnp's %
        norm_theta = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
        cost = norm_theta**2 + 0.1 * theta_dot**2 + 0.001 * u**2
        theta_dot = theta_dot + (
            3.0 * g / (2.0 * l) * torch.sin(theta) + 3.0 / (m * l**2) * u
        ) * dt
        theta_dot = torch.clamp(theta_dot, -max_speed, max_speed)
        theta = theta + theta_dot * dt
        done = torch.zeros_like(theta, dtype=torch.bool)
        return torch.stack([theta, theta_dot], dim=-1), -cost, done

    return EnvSpec(reset, obs, step, 3, 1, False, max_steps)

