"""Humanoid-scale locomotion environment — the port of
``evox_tpu/problems/neuroevolution/control/walker.py``.

A planar chain of unit point masses: stiff rod springs between neighbours,
actuated joint torques, gravity, spring-damper ground contact with
Coulomb-style friction, integrated by semi-implicit Euler in substeps. The
reward is forward speed of the centre of mass + 1 (alive bonus) - control
cost; the episode ends when the head falls below ``0.3 * n_links *
rod_length`` or the chain explodes. The default configuration has the
Humanoid interface numbers, ``obs_dim=244`` and ``act_dim=17``.

Batched as the port's other envs: ``obs`` and ``step`` work over any
leading dimensions and ``reset(generator, n, device)`` draws ``n`` states.
The state is one flat float32 vector per env, ``state_dim = 4 * n_masses
+ act_dim + 1`` wide:

- ``[0, 2N)``: positions, mass-major ``(x0, y0, x1, y1, ...)`` — the JAX
  state's ``pos.reshape(-1)``;
- ``[2N, 4N)``: velocities, laid out the same way;
- ``[4N, 4N + act_dim)``: the previous action;
- the last column: the step counter ``t`` as a float (the JAX state holds
  an int32; its plane form casts it to float32 anyway).
"""

from __future__ import annotations

import torch

from .envs import EnvSpec

# the physics constants, one source for chain_walker and for
# chain_walker_planes (kernels/rollout_mlp.py), as in the JAX package
WALKER_DEFAULTS = dict(
    n_masses=25,
    act_dim=17,
    max_steps=1000,
    substeps=5,
    dt=0.01,
    rod_length=0.2,
    rod_stiffness=2000.0,
    rod_damping=4.0,
    torque_scale=8.0,
    ground_stiffness=3000.0,
    ground_damping=10.0,
    friction=1.0,
    gravity=9.8,
    obs_dim=244,
)


def walker_config(**overrides) -> dict:
    """WALKER_DEFAULTS merged with ``overrides`` (unknown keys rejected)."""
    unknown = set(overrides) - set(WALKER_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown chain_walker parameters: {sorted(unknown)}")
    return {**WALKER_DEFAULTS, **overrides}


def walker_state_dim(n_masses: int, act_dim: int) -> int:
    return 4 * n_masses + act_dim + 1


def init_positions(n_masses: int, rod_length: float) -> torch.Tensor:
    """``(n_masses, 2)`` standing zig-zag: alternating small x offsets,
    stacked in y (walker.py ``_init_pos``, in float32 as there)."""
    idx = torch.arange(n_masses, dtype=torch.float32)
    zig = 0.3 * rod_length * torch.where(idx % 2 == 0, 1.0, -1.0)
    y = 0.02 + idx * rod_length * torch.sqrt(torch.tensor(1.0 - 0.09))
    return torch.stack([zig, y], dim=-1)


def chain_walker(
    n_masses: int = WALKER_DEFAULTS["n_masses"],
    act_dim: int = WALKER_DEFAULTS["act_dim"],
    max_steps: int = WALKER_DEFAULTS["max_steps"],
    substeps: int = WALKER_DEFAULTS["substeps"],
    dt: float = WALKER_DEFAULTS["dt"],
    rod_length: float = WALKER_DEFAULTS["rod_length"],
    rod_stiffness: float = WALKER_DEFAULTS["rod_stiffness"],
    rod_damping: float = WALKER_DEFAULTS["rod_damping"],
    torque_scale: float = WALKER_DEFAULTS["torque_scale"],
    ground_stiffness: float = WALKER_DEFAULTS["ground_stiffness"],
    ground_damping: float = WALKER_DEFAULTS["ground_damping"],
    friction: float = WALKER_DEFAULTS["friction"],
    gravity: float = WALKER_DEFAULTS["gravity"],
    obs_dim: int = WALKER_DEFAULTS["obs_dim"],
) -> EnvSpec:
    """Planar articulated chain with ground contact (Humanoid-shaped); the
    state layout is in the module docstring. Observation: root-relative
    positions, velocities, link cos/sin and angular speed, rod strain,
    per-mass contact force, previous action, root height, head height and
    root velocity, zero-padded or truncated to ``obs_dim``."""
    n_links = n_masses - 1
    if act_dim > n_links - 1:
        raise ValueError(
            f"act_dim={act_dim} needs at least {act_dim + 1} links "
            f"({act_dim + 2} masses)"
        )
    N, A = n_masses, act_dim
    stand_height = 0.3 * n_links * rod_length
    h = dt / substeps
    base_pos = init_positions(N, rod_length)

    def unpack(s: torch.Tensor):
        lead = s.shape[:-1]
        pos = s[..., : 2 * N].reshape(lead + (N, 2))
        vel = s[..., 2 * N : 4 * N].reshape(lead + (N, 2))
        return pos, vel, s[..., 4 * N : 4 * N + A], s[..., 4 * N + A]

    def pack(pos, vel, prev_a, t) -> torch.Tensor:
        lead = pos.shape[:-2]
        return torch.cat(
            [pos.reshape(lead + (2 * N,)), vel.reshape(lead + (2 * N,)), prev_a, t[..., None]],
            dim=-1,
        )

    def ground(pos, vel):
        """Per-mass contact normal force (action-independent)."""
        depth = torch.clamp_min(-pos[..., 1], 0.0)
        contact = (depth > 0.0).to(pos.dtype)
        f_n = ground_stiffness * depth - ground_damping * vel[..., 1] * contact
        return torch.clamp_min(f_n, 0.0) * contact

    def forces(pos, vel, scaled_act):
        """Total force on each mass, in walker.py's order of accumulation."""
        f = torch.zeros_like(pos)
        f[..., 1] -= gravity
        d = pos[..., 1:, :] - pos[..., :-1, :]
        dd = torch.sum(d * d, dim=-1) + 1e-12
        inv = torch.rsqrt(dd)
        dist = dd * inv
        u = d * inv[..., None]
        rel_v = torch.sum((vel[..., 1:, :] - vel[..., :-1, :]) * u, dim=-1)
        mag = rod_stiffness * (dist - rod_length) + rod_damping * rel_v
        f_rod = mag[..., None] * u
        f[..., :-1, :] += f_rod
        f[..., 1:, :] += -f_rod
        perp = torch.stack([-u[..., 1], u[..., 0]], dim=-1)
        tq = torch.zeros(scaled_act.shape[:-1] + (n_links,), dtype=pos.dtype, device=pos.device)
        tq[..., :A] = scaled_act
        f_tq = (tq * torch.clamp_max(inv, 1e6))[..., None] * perp
        f[..., :-1, :] += f_tq
        f[..., 1:, :] += -f_tq
        f_n = ground(pos, vel)
        vx = vel[..., 0]
        f_t = -torch.clamp(friction * f_n * torch.sign(vx), -torch.abs(vx) * 50.0,
                           torch.abs(vx) * 50.0)
        f[..., 1] += f_n
        f[..., 0] += f_t
        return f

    def reset(generator: torch.Generator, n: int, device) -> torch.Tensor:
        pos = base_pos.to(device) + 0.01 * torch.randn(
            (n, N, 2), generator=generator, device=device)
        vel = 0.01 * torch.randn((n, N, 2), generator=generator, device=device)
        zeros = torch.zeros((n,), device=device)
        return pack(pos, vel, torch.zeros((n, A), device=device), zeros)

    def obs(s: torch.Tensor) -> torch.Tensor:
        pos, vel, prev_a, _ = unpack(s)
        lead = s.shape[:-1]
        rel = pos - pos[..., :1, :]
        d = pos[..., 1:, :] - pos[..., :-1, :]
        dd = torch.sum(d * d, dim=-1) + 1e-12
        inv = torch.rsqrt(dd)
        dist = dd * inv
        strain = dist * (1.0 / rod_length) - 1.0
        rel_v = vel[..., 1:, :] - vel[..., :-1, :]
        ang_vel = (d[..., 0] * rel_v[..., 1] - d[..., 1] * rel_v[..., 0]) * (inv * inv)
        parts = torch.cat(
            [
                rel.reshape(lead + (2 * N,)),
                vel.reshape(lead + (2 * N,)),
                d[..., 0] * inv,
                d[..., 1] * inv,
                ang_vel,
                strain,
                ground(pos, vel) * 1e-2,
                prev_a,
                torch.stack([pos[..., 0, 1], pos[..., -1, 1], vel[..., 0, 0], vel[..., 0, 1]], -1),
            ],
            dim=-1,
        )
        k = parts.shape[-1]
        if k >= obs_dim:
            return parts[..., :obs_dim]
        return torch.cat([parts, parts.new_zeros(lead + (obs_dim - k,))], dim=-1)

    def step(s: torch.Tensor, action: torch.Tensor):
        pos, vel, _, t = unpack(s)
        tanh_a = torch.tanh(action)
        scaled_act = tanh_a * torque_scale
        for _ in range(substeps):
            vel = vel + h * forces(pos, vel, scaled_act)
            pos = pos + h * vel
        com_vx = torch.mean(vel[..., 0], dim=-1)
        ctrl_cost = 0.01 * torch.sum(tanh_a**2, dim=-1)
        flat = pos.reshape(pos.shape[:-2] + (2 * N,))
        exploded = (~torch.isfinite(flat)).any(-1) | (torch.amax(torch.abs(flat), -1) > 1e3)
        reward = com_vx + 1.0 - ctrl_cost
        done = (pos[..., -1, 1] < stand_height) | exploded | (t + 1 >= max_steps)
        return pack(pos, vel, action, t + 1), reward, done

    return EnvSpec(reset, obs, step, obs_dim, act_dim, False, max_steps)
