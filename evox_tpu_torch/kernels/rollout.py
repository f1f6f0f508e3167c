"""Fused policy rollout: whole episodes in one CUDA kernel.

The port of ``evox_tpu/kernels/rollout.py``. ``fused_rollout`` returns the
total episode reward of every env for a flat-genome tanh MLP
(``flat_mlp_policy`` layout) over environments in SoA form: a dict of
``(envs,)`` component planes. On a CUDA tensor it launches the hand-written
kernel of ``csrc/rollout.cu`` (one thread per env, the genome and the env
state in registers for all T steps, on the grid of :func:`launch_plan`;
that file's header says what bounds it). On a CPU tensor it runs
``fused_rollout_plain``, the same arithmetic as full-width PyTorch ops.
There is no other route: a CUDA tensor goes to the kernel or raises.

The JAX kernel traces any ``step_soa`` callable; the CUDA kernel knows only
the envs compiled into it (``SoAEnv.cuda_env``): pendulum, cartpole,
mountain car and acrobot, each at hidden widths 8 and 16 (``HIDDEN_WIDTHS``).
Another width or a user's own ``step_soa`` raises on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.cost import charge
from ..core.device import DeviceLike, check_device, resolve_device
from ..problems.neuroevolution.control.envs import (
    EnvSpec,
    acrobot,
    cartpole,
    mountain_car,
    pendulum,
)
from . import _build

# environments in SoA form: state is a dict of per-env component planes
SoAState = Dict[str, torch.Tensor]

# operations of one env step and its distinct trig calls, by the env's
# counterpart in csrc/rollout.cu (counted from that source)
ENV_OPS = {"pendulum": (25, 2), "cartpole": (36, 2), "mountain_car": (20, 1), "acrobot": (60, 8)}
# state planes an env reads, by observation width
_STATE_PLANES = {2: 2, 3: 2, 4: 4, 6: 4}


def rollout_work(n: int, episodes: int, steps: int, obs: int, hidden: int, act: int,
                 env: str) -> Tuple[int, int]:
    """(bytes, operations) that a fused rollout must move and do.

    Bytes: genomes read once, state planes read once, returns written once.
    Operations per env-step: the MLP's multiply-adds (2 each), one per tanh,
    one per distinct trig call, and the env step's arithmetic
    (:data:`ENV_OPS`). Counting a transcendental as one operation makes
    this a lower bound. ``steps`` is the env-steps this run's data needs.
    The bound column of PERF.md's kernel table and the cost analysis
    (``core/cost.py``, which charges every env the whole ``T``: the live
    steps are known only after the launch) both count so.
    """
    env_ops, trig = ENV_OPS[env]
    dim = obs * hidden + hidden + hidden * act + act
    nbytes = 4 * (n * dim + _STATE_PLANES[obs] * episodes * n + episodes * n)
    per_step = 2 * (obs * hidden + hidden * act) + hidden + trig + env_ops
    return nbytes, per_step * steps


class SoAEnv(NamedTuple):
    """An :class:`EnvSpec` re-expressed over SoA component planes.

    ``base`` keeps the batched spec (used for reset, so the fused and scan
    engines draw the same initial states); ``to_soa`` turns a state batch
    ``(n, state_dim)`` into the dict of ``(n,)`` planes that ``obs_soa`` and
    ``step_soa`` work on. ``step_soa`` returns ``(state, reward, done)``;
    rewards after an env's first ``done`` are dropped, as in the standard
    engine. ``terminating`` lets the kernel stop a warp once all its envs
    are done. ``cuda_env`` names the env's counterpart compiled into
    ``csrc/rollout.cu`` (``None``: no counterpart, CPU only).
    """

    base: EnvSpec
    to_soa: Callable[[torch.Tensor], SoAState]
    obs_soa: Callable[[SoAState], Tuple[torch.Tensor, ...]]
    step_soa: Callable[
        [SoAState, Tuple[torch.Tensor, ...]],
        Tuple[SoAState, torch.Tensor, torch.Tensor],
    ]
    terminating: bool = True
    cuda_env: Optional[str] = None


def pendulum_obs_soa(s: SoAState) -> Tuple[torch.Tensor, ...]:
    return (torch.cos(s["th"]), torch.sin(s["th"]), s["thdot"])


def pendulum_step_soa(s: SoAState, a: Tuple[torch.Tensor, ...]):
    """One step on ``(envs,)`` planes; the math of control/envs.pendulum."""
    max_speed, max_torque, dt, g = 8.0, 2.0, 0.05, 10.0
    th, thdot = s["th"], s["thdot"]
    u = torch.clamp(a[0], -max_torque, max_torque)
    # floored modulo, like jnp's % (fmod would truncate)
    norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
    cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
    thdot = thdot + (3.0 * g / 2.0 * torch.sin(th) + 3.0 * u) * dt
    thdot = torch.clamp(thdot, -max_speed, max_speed)
    never_done = torch.zeros_like(th, dtype=torch.bool)
    return {"th": th + thdot * dt, "thdot": thdot}, -cost, never_done


def pendulum_soa(max_steps: int = 200) -> SoAEnv:
    """The pendulum :class:`SoAEnv` (the north-star workload's env)."""
    return SoAEnv(
        base=pendulum(max_steps=max_steps),
        to_soa=lambda s: {"th": s[..., 0], "thdot": s[..., 1]},
        obs_soa=pendulum_obs_soa,
        step_soa=pendulum_step_soa,
        terminating=False,
        cuda_env="pendulum",
    )


def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every backend. PyTorch's CUDA kernel
    turns division by a Python scalar into multiplication by its
    reciprocal, which rounds differently from JAX and from the CUDA
    kernel; a 0-d tensor divisor keeps the true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def cartpole_soa(max_steps: int = 500) -> SoAEnv:
    """control/envs.cartpole over SoA planes (terminating: the kernel keeps
    a sticky done flag and stops a warp once all its envs are done)."""
    gravity, masscart, masspole = 9.8, 1.0, 0.1
    total_mass = masscart + masspole
    length = 0.5
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_limit = 12 * 2 * math.pi / 360
    x_limit = 2.4

    def obs_soa(s):
        return (s["x"], s["xd"], s["th"], s["thd"])

    def step_soa(s, a):
        # arithmetic select, 2c - 1 maps {0, 1} -> {-1, +1}
        go_right = (a[1] > a[0]).to(a[0].dtype)
        force = force_mag * (2.0 * go_right - 1.0)
        x, x_dot, th, th_dot = s["x"], s["xd"], s["th"], s["thd"]
        costh, sinth = torch.cos(th), torch.sin(th)
        temp = _true_div(force + polemass_length * th_dot**2 * sinth, total_mass)
        thacc = (gravity * sinth - costh * temp) / (
            length * (4.0 / 3.0 - _true_div(masspole * costh**2, total_mass))
        )
        xacc = temp - _true_div(polemass_length * thacc * costh, total_mass)
        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        th = th + tau * th_dot
        th_dot = th_dot + tau * thacc
        done = (torch.abs(x) > x_limit) | (torch.abs(th) > theta_limit)
        new = {"x": x, "xd": x_dot, "th": th, "thd": th_dot}
        return new, torch.ones_like(x), done

    return SoAEnv(
        base=cartpole(max_steps=max_steps),
        to_soa=lambda s: {
            "x": s[..., 0], "xd": s[..., 1], "th": s[..., 2], "thd": s[..., 3]
        },
        obs_soa=obs_soa,
        step_soa=step_soa,
        cuda_env="cartpole",
    )



def mountain_car_soa(max_steps: int = 999) -> SoAEnv:
    """control/envs.mountain_car over SoA planes, op for op as the JAX
    package's ``mountain_car_soa``: the wall stop is an arithmetic select,
    so a stopped velocity can be ``-0.0``."""
    power = 0.0015

    def obs_soa(s):
        return (s["pos"], s["vel"])

    def step_soa(s, a):
        pos, vel = s["pos"], s["vel"]
        force = torch.clamp(a[0], -1.0, 1.0)
        vel = vel + force * power - 0.0025 * torch.cos(3.0 * pos)
        vel = torch.clamp(vel, -0.07, 0.07)
        pos = torch.clamp(pos + vel, -1.2, 0.6)
        at_wall = ((pos <= -1.2) & (vel < 0)).to(vel.dtype)
        vel = vel * (1.0 - at_wall)
        done = pos >= 0.45
        reward = 100.0 * done.to(pos.dtype) - 0.1 * (force * force)
        return {"pos": pos, "vel": vel}, reward, done

    return SoAEnv(
        base=mountain_car(max_steps=max_steps),
        to_soa=lambda s: {"pos": s[..., 0], "vel": s[..., 1]},
        obs_soa=obs_soa,
        step_soa=step_soa,
        cuda_env="mountain_car",
    )


def acrobot_soa(max_steps: int = 500) -> SoAEnv:
    """control/envs.acrobot over SoA planes, op for op as the JAX package's
    ``acrobot_soa``: the 3-logit argmax is the nested select ``-c0 + (1 -
    c0) * inner`` (the first of equal maxima wins, as ``jnp.argmax``), and
    the expression tree is the JAX step's with Python's constant folding
    (``m1 * lc1**2`` is 0.25, ``jnp.pi / 2.0`` float32 1.5707964)."""
    dt = 0.2
    l1 = m1 = m2 = 1.0
    lc1 = lc2 = 0.5
    I1 = I2 = 1.0
    g = 9.8

    def obs_soa(s):
        t1, t2 = s["t1"], s["t2"]
        return (torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2), s["td1"], s["td2"])

    def step_soa(s, a):
        c0 = ((a[0] >= a[1]) & (a[0] >= a[2])).to(a[0].dtype)
        inner = (a[1] < a[2]).to(a[0].dtype)  # 0 -> torque 0, 1 -> +1
        torque = -c0 + (1.0 - c0) * inner
        t1, t2, td1, td2 = s["t1"], s["t2"], s["td1"], s["td2"]
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
        reward = done.to(t1.dtype) - 1.0  # 0 when done, else -1
        return {"t1": t1, "t2": t2, "td1": td1, "td2": td2}, reward, done

    return SoAEnv(
        base=acrobot(max_steps=max_steps),
        to_soa=lambda s: {"t1": s[..., 0], "t2": s[..., 1], "td1": s[..., 2], "td2": s[..., 3]},
        obs_soa=obs_soa,
        step_soa=step_soa,
        cuda_env="acrobot",
    )


def _mlp_act(
    theta_t: torch.Tensor,
    obs: Tuple[torch.Tensor, ...],
    obs_dim: int,
    hidden: int,
    act_dim: int,
) -> Tuple[torch.Tensor, ...]:
    """``(envs,)`` actions from TRANSPOSED genomes ``theta_t`` ``(dim, envs)``:
    each genome component is one row, so every term is a full-width plane.
    Order of operations as in the JAX kernel and the CUDA one: start from
    b1, accumulate over obs k, then over hidden j."""
    n1 = obs_dim * hidden
    n2 = n1 + hidden
    n3 = n2 + hidden * act_dim
    h = [theta_t[n1 + j] for j in range(hidden)]  # start from b1
    for k in range(obs_dim):
        for j in range(hidden):
            h[j] = h[j] + obs[k] * theta_t[k * hidden + j]
    th = [torch.tanh(hj) for hj in h]
    acts = []
    for i in range(act_dim):
        a = theta_t[n3 + i]  # b2[i]
        for j in range(hidden):
            a = a + th[j] * theta_t[n2 + j * act_dim + i]
        acts.append(a)
    return tuple(acts)


def _check_args(theta, init_state, obs_dim, hidden, act_dim, episodes) -> int:
    if theta.ndim != 2 or theta.dtype != torch.float32:
        raise ValueError(f"theta must be float32 (n, dim), got {theta.dtype} {tuple(theta.shape)}")
    n, dim = theta.shape
    expect_dim = obs_dim * hidden + hidden + hidden * act_dim + act_dim
    if dim != expect_dim:
        raise ValueError(
            f"theta dim {dim} != flat MLP size {expect_dim} for "
            f"({obs_dim} -> {hidden} -> {act_dim})"
        )
    for k, v in init_state.items():
        if v.shape != (episodes * n,) or v.dtype != torch.float32:
            raise ValueError(
                f"state plane {k!r} is {v.dtype} {tuple(v.shape)}, expected "
                f"float32 ({episodes * n},) = episodes*n, episode-major"
            )
    return n


def fused_rollout_plain(
    theta: torch.Tensor,
    init_state: SoAState,
    T: int,
    obs_dim: int = 3,
    hidden: int = 16,
    act_dim: int = 1,
    env: Optional[SoAEnv] = None,
    episodes: int = 1,
    stats: bool = False,
):
    """The kernel's own arithmetic on full ``(episodes*n,)`` planes, in plain
    PyTorch (the counterpart of the JAX tests' ``_loop_reference``). It
    runs all T steps; the kernel's early exit skips only steps whose
    rewards are masked, so the totals are the same. ``stats=True`` returns
    ``(totals, steps)``: besides the totals, each env's live steps (those
    whose reward counts)."""
    env = env if env is not None else pendulum_soa()
    _check_args(theta, init_state, obs_dim, hidden, act_dim, episodes)
    # episode-major: column e*n + i of theta_t is genome i
    theta_t = theta.t().repeat(1, episodes)
    state = dict(init_state)
    total = torch.zeros_like(next(iter(state.values())))
    done = torch.zeros_like(total)
    steps = torch.zeros(total.shape, dtype=torch.int64, device=total.device)
    for _ in range(T):
        obs = env.obs_soa(state)
        a = _mlp_act(theta_t, obs, obs_dim, hidden, act_dim)
        state, reward, step_done = env.step_soa(state, a)
        total = total + torch.where(done > 0.5, torch.zeros_like(reward), reward)
        if stats:
            steps = steps + (done < 0.5)
        done = torch.maximum(done, step_done.to(done.dtype))
    return (total, steps) if stats else total


# env name -> (id in csrc/rollout.cu, plane order, obs, act)
_CUDA_ENVS = {
    "pendulum": (0, ("th", "thdot"), 3, 1),
    "cartpole": (1, ("x", "xd", "th", "thd"), 4, 2),
    "mountain_car": (2, ("pos", "vel"), 2, 1),
    "acrobot": (3, ("t1", "t2", "td1", "td2"), 6, 3),
}
# the hidden widths csrc/rollout.cu has an instance of, for every env
HIDDEN_WIDTHS = (8, 16)
# csrc/rollout.cu's block, and the blocks an SM each (env, hidden) instance
# is built for (its __launch_bounds__: the registers its genome takes; the
# kernel's header has ptxas's report)
THREADS = 128
BLOCKS_PER_SM = {
    ("pendulum", 8): 4, ("pendulum", 16): 4,
    ("cartpole", 8): 4, ("cartpole", 16): 3,
    ("mountain_car", 8): 4, ("mountain_car", 16): 4,
    ("acrobot", 8): 4, ("acrobot", 16): 2,
}
# libdevice functions that csrc/rollout.cu reaches in another form than
# the plain version's PyTorch ops (name -> id of its check there): sincosf
# in place of sinf and cosf of one angle, and tanhf without its clamp
REPLACED_LIBDEVICE = {"sincosf": 0, "tanhf": 1}


def _instance(env_name: str, hidden: int) -> int:
    """The id of the (env, hidden) instance in csrc/rollout.cu."""
    if env_name not in _CUDA_ENVS:
        raise ValueError(f"no CUDA counterpart for {env_name!r}; built in: {sorted(_CUDA_ENVS)}")
    if hidden not in HIDDEN_WIDTHS:
        raise ValueError(
            f"the CUDA kernel for {env_name} is built for hidden widths "
            f"{HIDDEN_WIDTHS}, not {hidden}"
        )
    return _CUDA_ENVS[env_name][0]


def launch_plan(env_name: str, n: int, episodes: int, sms: int = 132, hidden: int = 16) -> dict:
    """The kernel's launch for ``n`` genomes and ``episodes`` episodes: one
    thread per env, ``(ceil(n / THREADS), episodes)`` blocks, and the waves
    that grid takes at the (env, hidden) instance's blocks an SM."""
    _instance(env_name, hidden)
    grid = (-(-n // THREADS), episodes)
    per_sm = BLOCKS_PER_SM[env_name, hidden]
    return {"threads": THREADS, "grid": grid, "blocks_per_sm": per_sm,
            "waves": grid[0] * grid[1] / (per_sm * sms)}


def kernel_occupancy(env_name: str, hidden: int = 16) -> dict:
    """The runtime's blocks an SM and registers a thread of an (env,
    hidden) kernel instance; builds the kernel."""
    fn = _build.function("rollout", "evox_rollout_occupancy", [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
    blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
    _build.check_launch("rollout", fn(_instance(env_name, hidden), hidden, ctypes.byref(blocks),
                                      ctypes.byref(regs)), "occupancy query")
    return {"blocks_per_sm": blocks.value, "registers": regs.value}


def check_replaced_libdevice(name: str) -> dict:
    """Hold a libdevice function that the kernel calls in another form
    (``REPLACED_LIBDEVICE``) against its original on the card, over all
    2^32 float32 bit patterns: the inputs whose results differ in any bit,
    the smallest such bit pattern, and the check's ms."""
    fn = _build.function("rollout", "evox_rollout_libdevice_check", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    result = torch.tensor([0, -1], dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.check_launch("rollout", fn(REPLACED_LIBDEVICE[name], result.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream),
                        f"{name} check")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    mismatches, first = result.tolist()
    return {"inputs": 2**32, "mismatches": mismatches,
            "first_mismatch_bits": None if mismatches == 0 else f"0x{first & 0xFFFFFFFF:08x}",
            "ms": ms}


def _launch(theta, init_state, T, obs_dim, hidden, act_dim, env, episodes, n):
    spec = _CUDA_ENVS.get(env.cuda_env)
    if spec is None:
        raise ValueError(
            "this SoAEnv has no CUDA counterpart in csrc/rollout.cu "
            f"(cuda_env={env.cuda_env!r}); built in: {sorted(_CUDA_ENVS)}"
        )
    env_id, keys, obs, act = spec
    if (obs_dim, act_dim) != (obs, act) or hidden not in HIDDEN_WIDTHS:
        raise ValueError(
            f"the CUDA kernel for {env.cuda_env} is compiled for MLPs "
            f"{obs}-h-{act} with h in {HIDDEN_WIDTHS}, got {obs_dim}-{hidden}-{act_dim}"
        )
    if set(init_state) != set(keys):
        raise ValueError(f"state planes {sorted(init_state)} != {sorted(keys)}")
    theta = theta.contiguous()
    planes = torch.stack([init_state[k] for k in keys]).contiguous()
    out = torch.empty(episodes * n, dtype=torch.float32, device=theta.device)
    if n == 0:
        return out
    fn = _build.function("rollout", "evox_fused_rollout", [
        ctypes.c_int,  # env id
        ctypes.c_void_p,  # theta (n, dim)
        ctypes.c_void_p,  # state planes (C, episodes*n)
        ctypes.c_void_p,  # out (episodes*n,)
        ctypes.c_int,  # n
        ctypes.c_int,  # episodes
        ctypes.c_int,  # T
        ctypes.c_int,  # obs_dim
        ctypes.c_int,  # hidden
        ctypes.c_int,  # act_dim
        ctypes.c_void_p,  # cudaStream_t
    ])
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            env_id, theta.data_ptr(), planes.data_ptr(), out.data_ptr(),
            n, episodes, int(T), obs_dim, hidden, act_dim, stream,
        )
    _build.check_launch("rollout", err, "fused_rollout")
    fused_rollout.launches += 1
    nbytes, ops = rollout_work(n, episodes, episodes * n * int(T), obs_dim, hidden, act_dim,
                               env.cuda_env)
    charge("fused_rollout", ops, nbytes)
    return out


def fused_rollout(
    theta: torch.Tensor,
    init_state: SoAState,
    T: int,
    obs_dim: int = 3,
    hidden: int = 16,
    act_dim: int = 1,
    env: Optional[SoAEnv] = None,
    episodes: int = 1,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Total episode reward per environment, fully fused.

    Args:
        theta: ``(n, dim)`` float32 flat MLP genomes (``flat_mlp_policy``
            layout), one row per individual.
        init_state: SoA env state, a dict of ``(episodes * n,)`` float32
            planes, EPISODE-MAJOR (all of episode 0's envs, then episode
            1's...). Env ``e*n + i`` runs genome ``i``.
        T: fixed episode length.
        obs_dim / hidden / act_dim: MLP shape.
        env: the :class:`SoAEnv` (default ``pendulum_soa()``).
        episodes: episodes per individual.
        device: where the inputs lie; ``None`` means ``"cuda"``. On ``cuda``
            the hand kernel runs; on ``cpu``, ``fused_rollout_plain``.

    The JAX kernel's ``tile`` and ``interpret`` arguments are TPU knobs: a
    tile sized the VMEM block and its (8, 128) padding, and interpret mode
    ran Pallas on the CPU. The CUDA kernel's launch comes from
    :func:`launch_plan` and masks the ragged edge, and the CPU route is the
    plain version, so neither has a counterpart.

    ``fused_rollout.launches`` counts kernel launches.

    Returns:
        ``(episodes * n,)`` total rewards, episode-major.
    """
    dev = resolve_device(device)
    env = env if env is not None else pendulum_soa()
    n = _check_args(theta, init_state, obs_dim, hidden, act_dim, episodes)
    check_device(theta, dev, "theta")
    for k, v in init_state.items():
        check_device(v, dev, f"state plane {k!r}")
    if dev.type == "cpu":
        return fused_rollout_plain(
            theta, init_state, T, obs_dim, hidden, act_dim, env, episodes
        )
    if dev.type == "cuda":
        return _launch(theta, init_state, T, obs_dim, hidden, act_dim, env, episodes, n)
    raise ValueError(f"fused_rollout runs on cuda or cpu, not {dev}")


fused_rollout.launches = 0
