"""Fused big-policy rollout: whole walker episodes of a per-individual
multi-layer tanh MLP in one CUDA kernel.

The port of ``evox_tpu/kernels/rollout_mlp.py``. ``fused_mlp_rollout``
returns the total episode reward of every env for policies given as
per-layer weight planes ``(fan_in, fan_out, n)`` and bias planes
``(fan_out, n)`` (individual in the last axis, the JAX package's layout),
over an env in plane form: a dict of ``(components, envs)`` planes
(:class:`PlaneEnv`). On a CUDA tensor it launches the hand-written kernel
of ``csrc/rollout_mlp.cu`` (one block per env, the env's policy in
shared memory for the episode, each dot product split over several
threads; that file's header says what bounds it). On a CPU tensor it runs
``fused_mlp_rollout_plain``, the same arithmetic as full-width PyTorch
ops. There is no other route: a CUDA tensor goes to the kernel or raises.

The plain version fixes every order of summation, and the kernel follows
it, so the two agree bit for bit on the card: each dot product is cut into
slices of whole quads of its inputs (:func:`_slice_bounds`), each slice
summed in order (slice 0 from the bias), and the slices combined by a fixed
tree (``_mlp_planes``); the sums over masses and actions of the walker's
reward run in index order (``_ordered_sum``), with a true division for the
mean. Maximum, minimum and sign propagate NaN as ``jnp`` does.

The TPU kernel kept a 128-individual tile's full weights (~10.8 MB)
resident in VMEM. An H100 SM has 228 KB of shared memory, so the CUDA
kernel keeps one env's policy per block: at the main path's 244-64-64-17
the instance built for it holds 56 KB in shared memory and the rest (the
64 x 64 layer and 12 of the first layer's 61 quads of inputs) in
registers, four blocks to an SM. :func:`fused_rollout_analysis` reports
that budget in place of the JAX package's ``_vmem_plan``/VMEM report.

``weight_dtype=torch.bfloat16`` is the JAX package's bf16 policy
residency: every weight and bias is rounded to bfloat16 (to nearest, ties
to even, as ``astype`` rounds) where the block copies it in, kept so in
shared memory (2 bytes a weight) and in registers widened back to float32,
and read as float32; the accumulators, the order of summation and the env
stay float32. The plain version rounds the planes the same way and then
runs its float32 arithmetic unchanged, so the two still agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.cost import charge
from ..core.device import DeviceLike, check_device, resolve_device
from ..problems.neuroevolution.control.envs import EnvSpec
from ..problems.neuroevolution.control.walker import chain_walker, walker_config
from . import _build
from .rollout import _true_div

PlaneState = Dict[str, torch.Tensor]


class PlaneEnv(NamedTuple):
    """An env in plane (component-major) form for the big-policy kernel.

    ``base``: the batched :class:`EnvSpec` (resets come from it, so the
    fused and scan engines draw the same initial states). ``to_planes``:
    state batch ``(n, state_dim)`` -> dict of ``(components, n)`` planes,
    with a ``"done"`` plane of zeros. ``obs_planes``: planes -> ``(obs_dim,
    n)``, rows in the order of the batched env's observation vector.
    ``step_planes``: ``(planes, act (act_dim, n)) -> (planes, reward (1, n),
    done (1, n) bool)``. ``cuda_env`` names the env's counterpart compiled
    into ``csrc/rollout_mlp.cu`` (``None``: CPU only) and ``config`` holds
    the constants it is given.
    ``exploded``: planes -> ``(1, n)`` bool, the env's own blow-up test
    (used to account for non-finite returns).
    """

    base: EnvSpec
    to_planes: Callable[[torch.Tensor], PlaneState]
    obs_planes: Callable[[PlaneState], torch.Tensor]
    step_planes: Callable[
        [PlaneState, torch.Tensor], Tuple[PlaneState, torch.Tensor, torch.Tensor]
    ]
    cuda_env: Optional[str] = None
    config: Optional[dict] = None
    exploded: Optional[Callable[[PlaneState], torch.Tensor]] = None


def mlp_rollout_work(sizes: Sequence[int], n: int, episodes: int, steps: int, n_masses: int,
                     act_dim: int, substeps: int) -> Tuple[int, int]:
    """(bytes, operations) that a fused walker rollout must move and do.

    Bytes: each individual's weights and biases read once, the state planes
    read once, the returns written once. Operations per live env-step,
    counted from csrc/rollout_mlp.cu: 2 per multiply-add of the MLP, one
    per tanh, ~32 per mass for the observation, ~60 per mass for each
    substep's forces and integration, and the reward's sums; a
    transcendental counts as one operation, so this is a lower bound.
    ``steps`` is the live env-steps this run's data needs. The bound column
    of PERF.md's kernel table and the cost analysis (``core/cost.py``,
    which charges every env the whole ``T``: the live steps are known only
    after the launch) both count so."""
    policy = sum(fi * fo + fo for fi, fo in zip(sizes[:-1], sizes[1:]))
    macs = sum(fi * fo for fi, fo in zip(sizes[:-1], sizes[1:]))
    nbytes = 4 * (n * policy + (4 * n_masses + act_dim + 2) * episodes * n + episodes * n)
    per_step = (2 * macs + sum(sizes[1:-1]) + 3 * act_dim + 32 * n_masses
                + 60 * n_masses * substeps + n_masses + 6)
    return nbytes, per_step * steps


def _const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``c`` as a 0-d float32 tensor beside ``x`` (rounded once, as a
    Python scalar in a float32 op is)."""
    return torch.full((), c, dtype=x.dtype, device=x.device)


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: NaN propagates (``clamp_min`` may drop it)."""
    return torch.maximum(x, _const(x, c))


def _minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, _const(x, c))


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: ±1, ±0 kept, NaN propagates (``torch.sign`` maps NaN
    to 0 on the CPU)."""
    one = _const(x, 1.0)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """``(C, n)`` -> ``(1, n)``: rows added in index order, the order the
    kernel adds them in (``torch.sum`` on the card picks its own)."""
    s = x[0:1]
    for r in range(1, x.shape[0]):
        s = s + x[r : r + 1]
    return s


# ------------------------------------------------------------ chain walker


def chain_walker_planes(**kwargs) -> PlaneEnv:
    """control/walker.py's chain_walker over ``(component, n)`` planes: the
    JAX package's ``chain_walker_planes``, masses in rows, envs in columns.
    Planes: ``px``, ``py``, ``vx``, ``vy`` ``(n_masses, n)``, ``pa`` (the
    previous action) ``(act_dim, n)``, ``t`` and ``done`` ``(1, n)``."""
    cfg = walker_config(**kwargs)
    base = chain_walker(**cfg)
    N, A = cfg["n_masses"], cfg["act_dim"]
    L = N - 1
    substeps, obs_dim, max_steps = cfg["substeps"], cfg["obs_dim"], cfg["max_steps"]
    rod_length, rod_stiffness = cfg["rod_length"], cfg["rod_stiffness"]
    rod_damping, torque_scale = cfg["rod_damping"], cfg["torque_scale"]
    ground_stiffness, ground_damping = cfg["ground_stiffness"], cfg["ground_damping"]
    friction, gravity = cfg["friction"], cfg["gravity"]
    stand_height = 0.3 * L * rod_length
    h = cfg["dt"] / substeps

    def to_planes(state: torch.Tensor) -> PlaneState:
        n = state.shape[0]
        pos = state[:, : 2 * N].reshape(n, N, 2)
        vel = state[:, 2 * N : 4 * N].reshape(n, N, 2)
        return {
            "px": pos[..., 0].T.contiguous(),
            "py": pos[..., 1].T.contiguous(),
            "vx": vel[..., 0].T.contiguous(),
            "vy": vel[..., 1].T.contiguous(),
            "pa": state[:, 4 * N : 4 * N + A].T.contiguous(),
            "t": state[:, 4 * N + A][None, :].contiguous(),
            "done": state.new_zeros((1, n)),
        }

    def _pad_ends(f: torch.Tensor) -> torch.Tensor:
        """``(L, n)`` per-link force -> per-mass: +f on the lower endpoint,
        -f on the upper."""
        zero = torch.zeros_like(f[:1])
        return torch.cat([f, zero]) - torch.cat([zero, f])

    def _ground(py, vy):
        depth = _maximum(-py, 0.0)
        contact = (depth > 0.0).to(py.dtype)
        f_n = ground_stiffness * depth - ground_damping * vy * contact
        return _maximum(f_n, 0.0) * contact

    def _links(px, py):
        dx = px[1:] - px[:-1]
        dy = py[1:] - py[:-1]
        dd = dx * dx + dy * dy + 1e-12
        inv = torch.rsqrt(dd)
        return dx, dy, dd, inv

    def _forces(px, py, vx, vy, scaled_act):
        dx, dy, dd, inv = _links(px, py)
        dist = dd * inv
        ux, uy = dx * inv, dy * inv
        rel_v = (vx[1:] - vx[:-1]) * ux + (vy[1:] - vy[:-1]) * uy
        mag = rod_stiffness * (dist - rod_length) + rod_damping * rel_v
        fx = _pad_ends(mag * ux)
        fy = -gravity + _pad_ends(mag * uy)
        tq = torch.cat([scaled_act, scaled_act.new_zeros((L - A,) + scaled_act.shape[1:])])
        coef = tq * _minimum(inv, 1e6)
        fx = fx + _pad_ends(coef * -uy)
        fy = fy + _pad_ends(coef * ux)
        f_n = _ground(py, vy)
        lim = torch.abs(vx) * 50.0
        f_t = -torch.minimum(torch.maximum(friction * f_n * _sign(vx), -lim), lim)
        return fx + f_t, fy + f_n

    def obs_planes(s: PlaneState) -> torch.Tensor:
        px, py, vx, vy = s["px"], s["py"], s["vx"], s["vy"]
        n = px.shape[-1]
        dx, dy, dd, inv = _links(px, py)
        strain = dd * inv * (1.0 / rod_length) - 1.0
        rvx = vx[1:] - vx[:-1]
        rvy = vy[1:] - vy[:-1]
        ang_vel = (dx * rvy - dy * rvx) * (inv * inv)
        # (m0x, m0y, m1x, ...), the batched env's pos.reshape(-1)
        rel = torch.stack([px - px[:1], py - py[:1]], dim=1).reshape(2 * N, n)
        vel = torch.stack([vx, vy], dim=1).reshape(2 * N, n)
        parts = torch.cat(
            [rel, vel, dx * inv, dy * inv, ang_vel, strain, _ground(py, vy) * 1e-2,
             s["pa"], py[:1], py[-1:], vx[:1], vy[:1]]
        )
        k = parts.shape[0]
        if k >= obs_dim:
            return parts[:obs_dim]
        return torch.cat([parts, parts.new_zeros((obs_dim - k, n))])

    def exploded(s: PlaneState) -> torch.Tensor:
        mx = torch.maximum(
            torch.amax(torch.abs(s["px"]), 0, keepdim=True),
            torch.amax(torch.abs(s["py"]), 0, keepdim=True),
        )
        return ~torch.isfinite(mx) | (mx > 1e3)

    def step_planes(s: PlaneState, act: torch.Tensor):
        px, py, vx, vy = s["px"], s["py"], s["vx"], s["vy"]
        ta = torch.tanh(act)  # substep-invariant
        scaled_act = ta * torque_scale
        for _ in range(substeps):
            fx, fy = _forces(px, py, vx, vy, scaled_act)
            vx = vx + h * fx
            vy = vy + h * fy
            px = px + h * vx
            py = py + h * vy
        com_vx = _true_div(_ordered_sum(vx), float(N))
        ctrl = 0.01 * _ordered_sum(ta * ta)
        reward = com_vx + 1.0 - ctrl
        t = s["t"] + 1.0
        new = dict(s)
        new.update(px=px, py=py, vx=vx, vy=vy, pa=act, t=t)
        fell = py[-1:] < _const(py, stand_height)
        done = fell | exploded(new) | (t >= _const(t, float(max_steps)))
        return new, reward, done

    return PlaneEnv(
        base=base,
        to_planes=to_planes,
        obs_planes=obs_planes,
        step_planes=step_planes,
        cuda_env="chain_walker",
        config=cfg,
        exploded=exploded,
    )


# ----------------------------------------------------------- plain version


def _slices(fan_in: int) -> int:
    """How many slices a dot product over ``fan_in`` inputs is cut into: 4,
    2 or 1, the most that leaves every slice at least one whole quad."""
    quads = -(-fan_in // 4)
    return 4 if quads >= 4 else (2 if quads >= 2 else 1)


def _slice_bounds(fan_in: int) -> Tuple[Tuple[int, int], ...]:
    """The ``[k0, k1)`` input range of each slice of a dot product over
    ``fan_in`` inputs: slice s takes quads ``[Q s // S, Q (s+1) // S)`` of
    the ``Q = ceil(fan_in / 4)`` quads, ``S = _slices(fan_in)``. The CUDA
    kernel cuts its dot products the same way (csrc/rollout_mlp.cu,
    ``dense``), and its launch plan takes S from :func:`_slices`."""
    quads, S = -(-fan_in // 4), _slices(fan_in)
    return tuple(
        (min(4 * (quads * s // S), fan_in), min(4 * (quads * (s + 1) // S), fan_in))
        for s in range(S)
    )


def _mlp_planes(weights, biases, obs: torch.Tensor, sizes, linear=()) -> torch.Tensor:
    """``(act_dim, n)`` actions, in the CUDA kernel's order of summation:
    per layer, each slice of :func:`_slice_bounds` adds ``h[k] * w[k]`` for
    its k in order, slice 0 starting from the bias plane and the others from
    their first product; the slices combine pairwise, ``(s0 + s1) + (s2 +
    s3)``. tanh after every layer but the last and those in ``linear``."""
    h = obs
    n_layers = len(sizes) - 1
    for li in range(n_layers):
        w = weights[li]
        parts = []
        for s, (k0, k1) in enumerate(_slice_bounds(sizes[li])):
            acc = biases[li] if s == 0 else h[k0 : k0 + 1] * w[k0]
            for k in range(k0 if s == 0 else k0 + 1, k1):
                acc = acc + h[k : k + 1] * w[k]
            parts.append(acc)
        while len(parts) > 1:
            parts = [parts[q] + parts[q + 1] for q in range(0, len(parts), 2)]
        acc = parts[0]
        h = acc if (li == n_layers - 1 or li in linear) else torch.tanh(acc)
    return h


def residency_bytes(weight_dtype: Optional[torch.dtype]) -> int:
    """Bytes a resident weight takes: 4 for ``None`` (float32 residency), 2
    for ``torch.bfloat16``; any other dtype raises ``ValueError``."""
    if weight_dtype is None:
        return 4
    if weight_dtype == torch.bfloat16:
        return 2
    raise ValueError(
        f"weight_dtype must be None (float32 residency) or torch.bfloat16, got {weight_dtype}"
    )


def _resident(x: torch.Tensor, weight_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A weight or bias plane as the kernel holds it: rounded to
    ``weight_dtype`` (to nearest, ties to even) and read back as float32."""
    return x if weight_dtype is None else x.to(weight_dtype).to(torch.float32)


def _check_args(weights, biases, init_state, sizes, episodes, linear) -> int:
    sizes = tuple(int(s) for s in sizes)
    n_layers = len(sizes) - 1
    if n_layers < 1 or len(weights) != n_layers or len(biases) != n_layers:
        raise ValueError(
            f"sizes {sizes} name {n_layers} layers; got {len(weights)} weight "
            f"and {len(biases)} bias planes"
        )
    if not set(linear) <= set(range(n_layers)):
        raise ValueError(
            f"linear {sorted(set(linear))} out of range for {n_layers} "
            "layers (negative indices not supported)"
        )
    n = weights[0].shape[-1]
    for li, (w, b) in enumerate(zip(weights, biases)):
        want_w, want_b = (sizes[li], sizes[li + 1], n), (sizes[li + 1], n)
        if w.dtype != torch.float32 or tuple(w.shape) != want_w:
            raise ValueError(f"weights[{li}] is {w.dtype} {tuple(w.shape)}, expected float32 {want_w}")
        if b.dtype != torch.float32 or tuple(b.shape) != want_b:
            raise ValueError(f"biases[{li}] is {b.dtype} {tuple(b.shape)}, expected float32 {want_b}")
    if "done" not in init_state:
        raise ValueError("init_state needs a 'done' plane (float 0/1)")
    for k, v in init_state.items():
        if v.dtype != torch.float32 or v.ndim != 2 or v.shape[1] != episodes * n:
            raise ValueError(
                f"state plane {k!r} is {v.dtype} {tuple(v.shape)}, expected "
                f"float32 (C, {episodes * n}) = episodes*n, episode-major"
            )
    return n


def fused_mlp_rollout_plain(
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    init_state: PlaneState,
    T: int,
    sizes: Sequence[int],
    env: PlaneEnv,
    episodes: int = 1,
    linear: Sequence[int] = (),
    stats: bool = False,
    weight_dtype: Optional[torch.dtype] = None,
):
    """The kernel's own arithmetic on full ``(C, episodes*n)`` planes, in
    plain PyTorch (the counterpart of the JAX tests' ``_loop_reference``).
    It runs all T steps; the kernel stops each env at its ``done``, which
    skips only masked rewards, so the totals are the same. With
    ``weight_dtype=torch.bfloat16`` each weight and bias plane is first
    rounded to bfloat16 and read back as float32 (:func:`_resident`); the
    arithmetic after that is the float32 one.

    ``stats=True`` returns ``(totals, steps, exploded)``: besides the
    totals, each env's live steps (those whose reward counts) and whether
    its episode ended by ``env.exploded``."""
    sizes = tuple(int(s) for s in sizes)
    linear = tuple(int(i) for i in linear)
    _check_args(weights, biases, init_state, sizes, episodes, linear)
    residency_bytes(weight_dtype)
    weights = tuple(_resident(w, weight_dtype) for w in weights)
    biases = tuple(_resident(b, weight_dtype) for b in biases)
    if episodes > 1:  # episode-major: column e*n + i runs individual i
        weights = tuple(w.repeat(1, 1, episodes) for w in weights)
        biases = tuple(b.repeat(1, episodes) for b in biases)
    state = dict(init_state)
    done = state.pop("done") > 0.5
    total = torch.zeros(done.shape, dtype=torch.float32, device=done.device)
    steps = torch.zeros(done.shape, dtype=torch.int64, device=done.device)
    blew = torch.zeros_like(done)
    for _ in range(int(T)):
        obs = env.obs_planes(state)
        act = _mlp_planes(weights, biases, obs, sizes, linear)
        state, reward, step_done = env.step_planes(state, act)
        total = total + torch.where(done, torch.zeros_like(reward), reward)
        if stats:
            live = ~done
            steps = steps + live
            if env.exploded is not None:
                blew = blew | (live & step_done & env.exploded(state))
        done = done | step_done
    if stats:
        return total.reshape(-1), steps.reshape(-1), blew.reshape(-1)
    return total.reshape(-1)


# ------------------------------------------------------ the Hopper budget

SMEM_PER_BLOCK_LIMIT = 232448  # 227 KB: the most one block may use (sm_90)
SMEM_PER_SM = 233472  # 228 KB of shared memory on an SM
SMEM_RESERVED_PER_BLOCK = 1024  # the runtime's own share of each resident block
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
MAX_LAYERS = 4
MAX_MASSES = 32  # the walker's physics runs one mass per lane of one warp
_PLANE_ORDER = ("px", "py", "vx", "vy", "pa", "t", "done")


# the instance of csrc/rollout_mlp.cu built for the main path's policy: 128
# threads (two outputs a thread), four blocks an SM; layer 1 (64 x 64) and
# the last MAIN_REG_QUADS quads of each slice of layer 0 in registers
MAIN_SIZES = (244, 64, 64, 17)
MAIN_THREADS = 128
MAIN_REG_QUADS = 3
REGISTERS_PER_SM = 65536
# the registers a thread both instances' __launch_bounds__ allow: 65536 /
# (4 blocks x 128 threads) and 65536 / (2 x 256)
REGISTERS_PER_THREAD = 128


class _Plan(NamedTuple):
    instance: str  # "main" or "generic"
    threads: int
    smem_bytes: int
    slices: Tuple[int, ...]  # S of each layer
    w_off: Tuple[int, ...]  # offsets in floats (0 for the layer in registers)
    b_off: Tuple[int, ...]
    h_off: Tuple[int, ...]  # the observation, then each layer's output
    scratch_off: int  # the reward's terms: vx by mass, tanh(action)^2 by action


def _smem_plan(
    sizes: Sequence[int], linear: Sequence[int] = (), weight_dtype: Optional[torch.dtype] = None
) -> _Plan:
    """The kernel's launch plan for one block (one env): the instance, the
    threads (generic: 32 / S outputs of a layer to a warp, enough warps for
    the widest layer, at most 256; main: 128, two outputs a thread), each
    layer's slice count (:func:`_slices`) and the shared-memory layout in
    float32s, each region 16-byte aligned: every layer's weights as
    ``[k/4][j][k%4]`` (but what the main instance holds in registers: layer
    1, and the last MAIN_REG_QUADS quads of each slice of layer 0), the
    biases, the activations padded to whole quads (the last layer's output
    is the action), and 64 floats for the reward's terms of a step. Offsets
    count 4-byte units whatever ``weight_dtype``; at bfloat16 the weight and
    bias regions hold 2 bytes an element, each region still 16-byte
    aligned. The single source of truth for the launch and for
    :func:`fused_rollout_analysis`."""
    sizes = tuple(int(x) for x in sizes)
    main = sizes == MAIN_SIZES and not tuple(linear)
    slices = tuple(_slices(fi) for fi in sizes[:-1])
    item = residency_bytes(weight_dtype)
    at = 0

    def take(count: int, itemsize: int = 4) -> int:
        nonlocal at
        off = at
        at += -(-count * itemsize // 16) * 4
        return off

    quads = [-(-fi // 4) for fi in sizes[:-1]]
    if main:  # layer 1, and three quads of each slice of layer 0, in registers
        quads[0] -= MAIN_REG_QUADS * slices[0]
        quads[1] = 0
    w_off = tuple(take(4 * q * fo, item) if q else 0 for q, fo in zip(quads, sizes[1:]))
    b_off = tuple(take(fo, item) for fo in sizes[1:])
    h_off = tuple(take(x) for x in sizes)
    scratch_off = take(2 * MAX_MASSES)
    widest = max(fo * S for fo, S in zip(sizes[1:], slices))
    threads = MAIN_THREADS if main else min(256, 32 * -(-widest // 32))
    return _Plan("main" if main else "generic", threads, 4 * at, slices, w_off, b_off, h_off,
                 scratch_off)


def fused_rollout_analysis(
    sizes: Sequence[int],
    env: Optional[PlaneEnv] = None,
    linear: Sequence[int] = (),
    weight_dtype: Optional[torch.dtype] = None,
) -> dict:
    """Host-side report of the kernel's Hopper budget for MLP ``sizes``
    (with ``linear`` layers) over ``env`` (default: the default chain
    walker), for the instance the launch would take: its threads a block,
    slices a layer, shared memory a block against the 227 KB a block may
    hold, the registers a thread its launch bounds allow, the blocks (envs)
    an SM keeps resident by all three, and the policy bytes each block
    resides (at ``weight_dtype``'s 2 bytes a weight for bfloat16). Negative
    headroom means the launch is refused (``fused_mlp_rollout`` raises). The
    counterpart of the JAX package's VMEM report."""
    cfg = (env.config if env is not None else None) or walker_config()
    sizes = tuple(int(s) for s in sizes)
    if not 3 <= cfg["n_masses"] <= MAX_MASSES:
        raise ValueError(f"the kernel runs 3 to {MAX_MASSES} masses, got {cfg['n_masses']}")
    plan = _smem_plan(sizes, linear, weight_dtype)
    per_block = plan.smem_bytes + SMEM_RESERVED_PER_BLOCK
    blocks = min(SMEM_PER_SM // per_block, MAX_THREADS_PER_SM // plan.threads,
                 REGISTERS_PER_SM // (plan.threads * REGISTERS_PER_THREAD), MAX_BLOCKS_PER_SM)
    policy = sum(fi * fo + fo for fi, fo in zip(sizes[:-1], sizes[1:]))
    return {
        "sizes": sizes,
        "weight_dtype": str(weight_dtype or torch.float32),
        "instance": plan.instance,
        "threads_per_block": plan.threads,
        "slices": plan.slices,
        "registers_per_thread": REGISTERS_PER_THREAD,
        "smem_bytes_per_block": plan.smem_bytes,
        "smem_limit_bytes": SMEM_PER_BLOCK_LIMIT,
        "headroom_bytes": SMEM_PER_BLOCK_LIMIT - plan.smem_bytes,
        "blocks_per_sm": blocks if plan.smem_bytes <= SMEM_PER_BLOCK_LIMIT else 0,
        "policy_floats": policy,
        "policy_bytes": residency_bytes(weight_dtype) * policy,
    }


# ---------------------------------------------------------------- launch


def _launch(weights, biases, init_state, T, sizes, env, episodes, linear, weight_dtype,
            n) -> torch.Tensor:
    if env.cuda_env != "chain_walker" or env.config is None:
        raise ValueError(
            "this PlaneEnv has no CUDA counterpart in csrc/rollout_mlp.cu "
            f"(cuda_env={env.cuda_env!r}); built in: ['chain_walker']"
        )
    cfg = env.config
    N, A = cfg["n_masses"], cfg["act_dim"]
    n_layers = len(sizes) - 1
    if n_layers > MAX_LAYERS or N > MAX_MASSES:
        raise ValueError(
            f"the CUDA kernel takes at most {MAX_LAYERS} layers and "
            f"{MAX_MASSES} masses, got {n_layers} and {N}"
        )
    if sizes[0] != cfg["obs_dim"] or sizes[-1] != A:
        raise ValueError(f"policy sizes {sizes} do not match the walker ({cfg['obs_dim']} -> {A})")
    plan = _smem_plan(sizes, linear, weight_dtype)
    if plan.smem_bytes > SMEM_PER_BLOCK_LIMIT:
        raise ValueError(
            f"the policy {sizes} needs {plan.smem_bytes} bytes of shared memory "
            f"per block, more than the {SMEM_PER_BLOCK_LIMIT} a block may use"
        )
    rows = {"px": N, "py": N, "vx": N, "vy": N, "pa": A, "t": 1, "done": 1}
    if {k: v.shape[0] for k, v in init_state.items()} != rows:
        raise ValueError(f"state planes {sorted(init_state)} != walker planes {rows}")
    if not 1 <= episodes <= 65535:
        raise ValueError(f"episodes must be in [1, 65535], got {episodes}")
    planes = torch.cat([init_state[k] for k in _PLANE_ORDER]).contiguous()
    out = torch.empty(episodes * n, dtype=torch.float32, device=planes.device)
    if n == 0:
        return out

    pad = lambda xs, k: list(xs) + [0] * (k - len(xs))
    fan = pad(sizes, MAX_LAYERS + 1)
    w_strides = [w.stride() for w in weights] + [(0, 0, 0)] * (MAX_LAYERS - n_layers)
    b_strides = [b.stride() for b in biases] + [(0, 0)] * (MAX_LAYERS - n_layers)
    ints = (
        [n_layers, *fan, *pad(plan.slices, MAX_LAYERS), sum(1 << i for i in set(linear)), n,
         episodes, int(T), N, A, cfg["substeps"], int(plan.instance == "main"), plan.threads,
         plan.smem_bytes]
        + pad(plan.w_off, MAX_LAYERS) + pad(plan.b_off, MAX_LAYERS)
        + pad(plan.h_off, MAX_LAYERS + 1) + [plan.scratch_off]
        + [s[0] for s in w_strides] + [s[1] for s in w_strides] + [s[2] for s in w_strides]
        + [s[0] for s in b_strides] + [s[1] for s in b_strides]
        + [int(weight_dtype == torch.bfloat16)]
    )
    rod_length = cfg["rod_length"]
    floats = [
        cfg["dt"] / cfg["substeps"], rod_length, 1.0 / rod_length, cfg["rod_stiffness"],
        cfg["rod_damping"], cfg["torque_scale"], cfg["ground_stiffness"],
        cfg["ground_damping"], cfg["friction"], cfg["gravity"],
        0.3 * (N - 1) * rod_length, float(cfg["max_steps"]), float(N),
    ]
    ptrs = (
        pad([w.data_ptr() for w in weights], MAX_LAYERS)
        + pad([b.data_ptr() for b in biases], MAX_LAYERS)
        + [planes.data_ptr(), out.data_ptr()]
    )
    fn = _build.function("rollout_mlp", "evox_fused_mlp_rollout", [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,  # ints (csrc: kInts)
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,  # walker constants (kFloats)
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,  # device pointers (kPtrs)
        ctypes.c_void_p,  # cudaStream_t
    ])
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            (ctypes.c_longlong * len(ints))(*ints), len(ints),
            (ctypes.c_float * len(floats))(*floats), len(floats),
            (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
            stream,
        )
    _build.check_launch("rollout_mlp", err, "fused_mlp_rollout")
    fused_mlp_rollout.launches += 1
    nbytes, ops = mlp_rollout_work(sizes, n, episodes, episodes * n * int(T), N, A,
                                   cfg["substeps"])
    charge("fused_mlp_rollout", ops, nbytes)
    return out


def fused_mlp_rollout(
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    init_state: PlaneState,
    T: int,
    sizes: Sequence[int],
    env: PlaneEnv,
    episodes: int = 1,
    linear: Sequence[int] = (),
    weight_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Total episode reward per env, fully fused.

    Args:
        weights: per layer ``(fan_in, fan_out, n)`` float32 (individual
            last). Any strides: the engine hands in permuted views of the
            ``(pop, dim)`` genomes, and the kernel reads them in place.
        biases: per layer ``(fan_out, n)``, any strides.
        init_state: dict of ``(C, episodes * n)`` float32 planes,
            EPISODE-MAJOR (env ``e*n + i`` runs individual ``i``), with a
            ``"done"`` plane (float 0/1) taken as the initial done mask.
        T: horizon; sizes: ``(obs, h1, ..., act)``.
        env: the :class:`PlaneEnv` whose ``step_planes``/``obs_planes``
            the JAX package takes as two callables; the kernel runs its
            ``cuda_env`` counterpart.
        linear: layer indices with no tanh after them (low-rank layers).
        weight_dtype: ``None`` (float32 residency) or ``torch.bfloat16``,
            the JAX package's bf16 policy residency (module docstring): the
            kernel rounds the float32 planes it is given as it copies them
            in, so no bfloat16 copy of the population is made. Any other
            dtype raises ``ValueError``.
        device: where the inputs lie; ``None`` means ``"cuda"``.

    The JAX kernel's ``tile`` and ``interpret`` arguments are TPU knobs: a
    tile sized the VMEM-resident block of individuals, and interpret mode
    ran Pallas on the CPU. The CUDA kernel has one block per env, and the
    CPU route is the plain version, so neither has a counterpart; nor has
    ``early_stop``, since every block stops at its own env's ``done`` and
    the totals do not depend on it.

    ``fused_mlp_rollout.launches`` counts kernel launches.

    Returns:
        ``(episodes * n,)`` float32 total rewards, episode-major.
    """
    residency_bytes(weight_dtype)
    dev = resolve_device(device)
    sizes = tuple(int(s) for s in sizes)
    linear = tuple(int(i) for i in linear)
    n = _check_args(weights, biases, init_state, sizes, episodes, linear)
    for name, group in (("weights", weights), ("biases", biases)):
        for li, x in enumerate(group):
            check_device(x, dev, f"{name}[{li}]")
    for k, v in init_state.items():
        check_device(v, dev, f"state plane {k!r}")
    if dev.type == "cpu":
        return fused_mlp_rollout_plain(weights, biases, init_state, T, sizes, env, episodes, linear,
                                       weight_dtype=weight_dtype)
    if dev.type == "cuda":
        return _launch(weights, biases, init_state, T, sizes, env, episodes, linear, weight_dtype,
                       n)
    raise ValueError(f"fused_mlp_rollout runs on cuda or cpu, not {dev}")


fused_mlp_rollout.launches = 0

