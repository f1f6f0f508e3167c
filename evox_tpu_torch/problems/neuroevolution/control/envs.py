"""Classic-control environments in PyTorch — the port of
``evox_tpu/problems/neuroevolution/control/envs.py``: cartpole, pendulum,
mountain car and acrobot, ``ENVS`` and ``make``.

The JAX package writes each env for one instance and vmaps it; here the
batch dimensions are written out: ``obs`` and ``step`` take a state of
shape ``(..., state_dim)`` and an action ``(..., act_dim)`` and work over
any leading dimensions, and ``reset(generator, n, device)`` draws ``n``
initial states at once (``device=None`` means ``"cuda"``). Dynamics follow
the standard OpenAI-Gym formulations (CartPole-v1, Pendulum-v1,
MountainCarContinuous-v0, Acrobot-v1).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ....core.device import DeviceLike, resolve_device


class EnvSpec(NamedTuple):
    reset: Callable  # (generator, n, device) -> state (n, state_dim)
    obs: Callable  # (state (..., state_dim)) -> observation (..., obs_dim)
    step: Callable  # (state, action) -> (state, reward (...), done (...) bool)
    obs_dim: int
    act_dim: int
    discrete: bool
    max_steps: int


def _uniform(
    generator: torch.Generator, shape, lo: float, hi: float, device: DeviceLike
) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=resolve_device(device), dtype=torch.float32)
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



# ----------------------------------------------------------------- mountain car

def mountain_car(max_steps: int = 999) -> EnvSpec:
    power = 0.0015

    def reset(generator, n, device):
        pos = _uniform(generator, (n,), -0.6, -0.4, device)
        return torch.stack([pos, torch.zeros_like(pos)], dim=-1)

    def obs(s):
        return s

    def step(s, action):
        pos, vel = s[..., 0], s[..., 1]
        force = torch.clamp(action[..., 0], -1.0, 1.0)
        vel = vel + force * power - 0.0025 * torch.cos(3.0 * pos)
        vel = torch.clamp(vel, -0.07, 0.07)
        pos = torch.clamp(pos + vel, -1.2, 0.6)
        vel = torch.where((pos <= -1.2) & (vel < 0), 0.0, vel)
        done = pos >= 0.45
        reward = torch.where(done, 100.0, 0.0) - 0.1 * (force * force)
        return torch.stack([pos, vel], dim=-1), reward, done

    return EnvSpec(reset, obs, step, 2, 1, False, max_steps)


# -------------------------------------------------------------------- acrobot

def acrobot(max_steps: int = 500) -> EnvSpec:
    dt = 0.2
    l1 = m1 = m2 = 1.0
    lc1 = lc2 = 0.5
    I1 = I2 = 1.0
    g = 9.8

    def reset(generator, n, device):
        return _uniform(generator, (n, 4), -0.1, 0.1, device)

    def obs(s):
        t1, t2, td1, td2 = s.unbind(-1)
        return torch.stack(
            [torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2), td1, td2], dim=-1
        )

    def step(s, action):
        # the first of equal maxima wins, as jnp.argmax
        torque = torch.clamp(torch.argmax(action, dim=-1).to(s.dtype) - 1.0, -1.0, 1.0)
        t1, t2, td1, td2 = s.unbind(-1)
        # the expression tree of the JAX step, Python's constant folding
        # included; a tensor's square is a product, as jnp's ``x**2`` is
        d1 = (
            m1 * lc1**2
            + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(t2))
            + I1
            + I2
        )
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(t2)) + I2
        phi2 = m2 * lc2 * g * torch.cos(t1 + t2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * (td2 * td2) * torch.sin(t2)
            - 2 * m2 * l1 * lc2 * td2 * td1 * torch.sin(t2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(t1 - math.pi / 2.0)
            + phi2
        )
        tdd2 = (
            torque + d2 / d1 * phi1 - m2 * l1 * lc2 * (td1 * td1) * torch.sin(t2) - phi2
        ) / (m2 * lc2**2 + I2 - (d2 * d2) / d1)
        tdd1 = -(d2 * tdd2 + phi1) / d1
        td1 = torch.clamp(td1 + dt * tdd1, -4 * math.pi, 4 * math.pi)
        td2 = torch.clamp(td2 + dt * tdd2, -9 * math.pi, 9 * math.pi)
        t1 = t1 + dt * td1
        t2 = t2 + dt * td2
        done = -torch.cos(t1) - torch.cos(t2 + t1) > 1.0
        reward = torch.where(done, 0.0, -1.0)
        return torch.stack([t1, t2, td1, td2], dim=-1), reward, done

    return EnvSpec(reset, obs, step, 6, 3, True, max_steps)


ENVS = {
    "cartpole": cartpole,
    "pendulum": pendulum,
    "mountain_car": mountain_car,
    "acrobot": acrobot,
}


def make(name: str, **kwargs) -> EnvSpec:
    if name not in ENVS:
        raise ValueError(f"unknown env {name!r}; options: {sorted(ENVS)}")
    return ENVS[name](**kwargs)
