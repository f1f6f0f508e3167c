"""Meta-training for LES (Lange et al. 2023, arXiv:2211.11260 §4) — the port
of ``evox_tpu/algorithms/so/es/les_meta.py``: the bundled parameters, their
flat layout, and the meta-training that makes them.

``data/les_params.npz`` (this package's own copy of the JAX package's file)
holds the 214 floats of the two networks as one flat vector, in
``jax.flatten_util.ravel_pytree``'s order of the flax parameter tree:
dict keys sorted (``lr`` before ``weights``, ``Dense_0`` before
``Dense_1``, ``bias`` before ``kernel``), each leaf row-major. A flax
``Dense`` kernel is ``(in, out)``, applied as ``x @ kernel + bias``.

The meta-training is an outer OpenES over those 214 floats whose
meta-fitness is LES's own optimisation performance: the mean log10 of
the best gap LES reaches in ``INNER_GENS`` generations, over
``TASKS_PER_GEN`` tasks of five families (a shifted and rotated sphere,
an ill-conditioned ellipsoid, rastrigin, rosenbrock, and a teacher-student
MLP regression), each family's optimum at 0. A meta-step runs the
``OUTER_POP x TASKS_PER_GEN`` LES runs together: LES's ask and tell
(:func:`~evox_tpu_torch.algorithms.so.es.les.les_ask` and ``les_tell``,
the functions :class:`LES` itself calls) under ``torch.func.vmap`` over
the outer candidates and the tasks, and the five families computed for
every task and selected by its family index. Every candidate sees the same
tasks and inner draws (common random numbers), and the families are
stratified (task ``i`` is of family ``i mod 5``).

A meta-step's draws go through :class:`MetaTrainer`'s two draw methods,
which tests replace with the JAX package's draws: ``_draw_tasks`` (the
tasks) and ``_draw_inner`` (all ``INNER_GENS`` generations' standard
normals of every task, one launch); the outer OpenES draws through its
own ``_draw_noise``. A meta-step reads nothing back to the host; the
logged best is read only when ``progress_every`` asks for it.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ....core.device import DeviceLike, resolve_device
from ....utils.common import generator, rank_based_fitness, split_seed

PARAMS_PATH = Path(__file__).parent / "data" / "les_params.npz"

# the networks' layers in ravel order: (network, layer, in, out)
LAYERS = (
    ("lr", "Dense_0", 6, 16),
    ("lr", "Dense_1", 16, 2),
    ("weights", "Dense_0", 3, 8),
    ("weights", "Dense_1", 3, 8),
    ("weights", "Dense_2", 3, 1),
)
N_PARAMS = sum(fan_out + fan_in * fan_out for _, _, fan_in, fan_out in LAYERS)  # 214

Params = Dict[str, Dict[str, Dict[str, torch.Tensor]]]
Task = Dict[str, torch.Tensor]

# the meta-training configuration (the JAX package's, so the bundled file
# is reproducible from the source alone)
META_DIM = 8
INNER_POP = 16
INNER_GENS = 40
TASKS_PER_GEN = 10
N_FAMILIES = 5
OUTER_POP = 64
OUTER_GENS = 4000
OUTER_LR = 0.03
OUTER_STD = 0.05

# the teacher-student family's fixed probe inputs: the JAX package's
# jnp.linspace(-1.0, 1.0, 16) as XLA rounds it in float32
_MLP_INPUTS = np.array([
    -1.0, -0.8666666746139526, -0.7333333492279053, -0.5999999642372131,
    -0.46666666865348816, -0.333333283662796, -0.19999994337558746, -0.0666666105389595,
    0.06666672229766846, 0.20000004768371582, 0.3333333730697632, 0.46666672825813293,
    0.6000001430511475, 0.7333334684371948, 0.8666667938232422, 1.0,
], dtype=np.float32)


def unravel(flat, device: Optional[torch.device] = None) -> Params:
    """The parameter dict ``{network: {layer: {"bias", "kernel"}}}`` from
    the flat vector(s), in ravel order: numpy or a tensor, with any leading
    batch axes (each leaf keeps them). ``device`` defaults to the tensor's
    own, or the CPU."""
    if not isinstance(flat, torch.Tensor):
        flat = torch.from_numpy(np.array(flat, dtype=np.float32))
    flat = flat.to(device=device if device is not None else flat.device, dtype=torch.float32)
    if flat.shape[-1:] != (N_PARAMS,):
        raise ValueError(f"expected {N_PARAMS} LES parameters, got shape {tuple(flat.shape)}")
    batch = flat.shape[:-1]
    params: Params = {}
    at = 0
    for net, layer, fan_in, fan_out in LAYERS:
        bias = flat[..., at : at + fan_out]
        at += fan_out
        kernel = flat[..., at : at + fan_in * fan_out].reshape(*batch, fan_in, fan_out)
        at += fan_in * fan_out
        params.setdefault(net, {})[layer] = {"bias": bias.clone(), "kernel": kernel.clone()}
    return params


def ravel(params: Params) -> torch.Tensor:
    """The flat vector of a parameter dict (``unravel``'s inverse), leading
    batch axes kept."""
    leaves = []
    for net, layer, fan_in, fan_out in LAYERS:
        for kind in ("bias", "kernel"):
            leaf = params[net][layer][kind]
            leaves.append(leaf.reshape(*leaf.shape[: leaf.ndim - (1 if kind == "bias" else 2)], -1))
    return torch.cat(leaves, dim=-1)


def load_params(path: Path = PARAMS_PATH, device: DeviceLike = None) -> Optional[Params]:
    """The bundled parameters on ``device`` (``None`` means ``"cuda"``), or
    ``None`` when there is no file or it holds another number of floats."""
    dev = resolve_device(device)
    if not Path(path).exists():
        return None
    flat = np.load(path)["flat"]
    if flat.shape != (N_PARAMS,):  # the architecture drifted past the file
        return None
    return unravel(flat, dev)


def save_params(flat, path: Path = PARAMS_PATH) -> None:
    """Write the flat vector as ``np.savez(path, flat=...)``, the JAX
    package's format (the default path is the bundled file)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(flat, torch.Tensor):
        flat = flat.detach().cpu().numpy()
    np.savez(path, flat=np.asarray(flat, dtype=np.float32))


# ------------------------------------------------------------- the tasks


def _tiny_mlp_forward(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """1-2-1 tanh net from the first 7 entries of ``p``: ``(..., 7+)``
    params, ``(k,)`` inputs -> ``(..., k)`` outputs."""
    w1 = p[..., 0:2]
    b1 = p[..., 2:4]
    w2 = p[..., 4:6]
    b2 = p[..., 6]
    h = torch.tanh(u[:, None] * w1[..., None, :] + b1[..., None, :])
    return torch.sum(h * w2[..., None, :], dim=-1) + b2[..., None]


@functools.lru_cache(maxsize=None)
def mlp_inputs(device: torch.device) -> torch.Tensor:
    """The probe inputs on ``device``, copied there once: ``task_eval``
    runs every inner generation, and a fresh host copy each time would
    wait for the card. Read only."""
    return torch.tensor(_MLP_INPUTS, device=device)


def sample_tasks(seed: int, n: int, dim: int, device: DeviceLike = None) -> Task:
    """``n`` random tasks, stacked: family index (``type``), shift, a QR
    rotation, conditioning ``alphas`` and, for the MLP family, a random
    teacher's probe outputs. One launch a kind of draw."""
    dev = resolve_device(device)
    g = generator(seed, dev)
    kind = torch.randint(0, N_FAMILIES, (n,), generator=g, device=dev, dtype=torch.int32)
    shift = torch.rand((n, dim), generator=g, device=dev) * 4.0 - 2.0
    rot, _ = torch.linalg.qr(torch.randn((n, dim, dim), generator=g, device=dev))
    alphas = 10.0 ** (torch.rand((n, dim), generator=g, device=dev) * 3.0)
    teacher = _tiny_mlp_forward(1.5 * torch.randn((n, 7), generator=g, device=dev),
                                mlp_inputs(dev))
    return {"type": kind, "shift": shift, "rot": rot, "alphas": alphas, "teacher": teacher}


def sample_task(seed: int, dim: int, device: DeviceLike = None) -> Task:
    """One random task (:func:`sample_tasks` with ``n`` 1)."""
    return {k: v[0] for k, v in sample_tasks(seed, 1, dim, device).items()}


def task_eval(task: Task, x: torch.Tensor) -> torch.Tensor:
    """Batched evaluation ``(pop, dim) -> (pop,)``; every family has its
    optimum at 0, so the meta-score compares log-gaps across families. All
    five families are computed and the task's is selected (``torch.where``
    on ``type``), so the function runs under ``torch.func.vmap`` over a
    batch of tasks."""
    y = (x - task["shift"]) @ task["rot"].T
    dim = y.shape[-1]
    sphere = torch.sum(y**2, dim=-1)
    ellipsoid = torch.sum(task["alphas"] * y**2, dim=-1)
    rastrigin = 10.0 * dim + torch.sum(y**2 - 10.0 * torch.cos(2.0 * math.pi * y), dim=-1)
    z = y + 1.0
    rosenbrock = torch.sum(100.0 * (z[..., 1:] - z[..., :-1] ** 2) ** 2
                           + (1.0 - z[..., :-1]) ** 2, dim=-1)
    # teacher-student regression: y's first 7 entries are the student
    out = _tiny_mlp_forward(y, mlp_inputs(y.device))
    mlp_loss = torch.mean((out - task["teacher"]) ** 2, dim=-1)
    kind = task["type"]
    return torch.where(kind == 0, sphere, torch.where(
        kind == 1, ellipsoid, torch.where(
            kind == 2, rastrigin, torch.where(kind == 3, rosenbrock, mlp_loss))))


# ------------------------------------------------------------- the score


def les_score(params: Params, tasks: Task, noise: torch.Tensor) -> torch.Tensor:
    """The log10 best-gap of LES with ``params`` on each task, every run
    started at the origin with sigma 1: ``params`` with a leading axis of
    ``B`` candidates (``unravel`` of a ``(B, 214)`` batch), ``tasks``
    stacked over ``T``, and ``noise`` the ``(gens, T, pop, dim)`` inner
    standard normals every candidate shares. Returns ``(B, T)``. The
    candidates and tasks go through LES's own ``les_ask``/``les_tell``
    under two ``torch.func.vmap``s, generation by generation."""
    from .les import LESState, les_ask, les_tell, timescales

    gens, n_tasks, pop, dim = noise.shape
    n_cand = params["lr"]["Dense_0"]["bias"].shape[0]
    dev = noise.device
    ts = timescales(dev)

    def generation(p, mean, sigma, path_mean, path_sigma, task, z):
        # the state's tensors cross the vmaps as plain arguments; the
        # population is ask's to fill
        s = LESState(mean=mean, sigma=sigma, path_mean=path_mean, path_sigma=path_sigma,
                     population=z, seed=0)
        cand, s = les_ask(p, s, z)
        fit = task_eval(task, cand)
        s = les_tell(p, s, fit, ts)
        return s.mean, s.sigma, s.path_mean, s.path_sigma, torch.min(fit)

    # over tasks (the candidate's params shared), then over candidates (the
    # tasks and draws shared)
    per_task = torch.func.vmap(generation, in_dims=(None, 0, 0, 0, 0, 0, 0))
    step = torch.func.vmap(per_task, in_dims=(0, 0, 0, 0, 0, None, None))
    mean = torch.zeros((n_cand, n_tasks, dim), device=dev)
    state = (mean, torch.ones_like(mean), torch.zeros((n_cand, n_tasks, 3, dim), device=dev),
             torch.zeros((n_cand, n_tasks, 3, dim), device=dev))
    best = None
    for g in range(gens):
        *state, gen_best = step(params, *state, tasks, noise[g])
        best = gen_best if best is None else torch.minimum(best, gen_best)
    return torch.log10(best + 1e-10)


def _template_params(pop: int, dim: int, device: torch.device) -> Params:
    """A parameter dict of the right structure: LES's seeded random
    initialisation (seed 0). Both networks are shape-agnostic, so ``pop``
    and ``dim`` do not change it. It cannot equal the JAX package's flax
    draws."""
    from .les import random_params

    return random_params(0, device)


# ---------------------------------------------------------- meta-training


class MetaTrainer:
    """The outer OpenES over the 214 LES parameters and its meta-step, at
    the JAX package's configuration unless told otherwise. ``device``:
    ``None`` means ``"cuda"``."""

    def __init__(self, seed: int = 0, outer_pop: int = OUTER_POP,
                 tasks_per_gen: int = TASKS_PER_GEN, inner_pop: int = INNER_POP,
                 inner_gens: int = INNER_GENS, dim: int = META_DIM,
                 center_init: Optional[torch.Tensor] = None, device: DeviceLike = None):
        from .open_es import OpenES

        self.device = resolve_device(device)
        self.tasks_per_gen, self.inner_pop = tasks_per_gen, inner_pop
        self.inner_gens, self.dim = inner_gens, dim
        if center_init is None:
            center_init = ravel(_template_params(inner_pop, dim, self.device))
        self.outer = OpenES(center_init, outer_pop, learning_rate=OUTER_LR,
                            noise_stdev=OUTER_STD, device=self.device)
        self.seed = seed

    def init(self) -> Tuple[object, int]:
        """The outer OpenES state and the meta-step seed stream."""
        seed, outer_seed = split_seed(self.seed)
        return self.outer.init(outer_seed), seed

    def _draw_tasks(self, seed: int) -> Task:
        """A meta-step's tasks, their families stratified."""
        tasks = sample_tasks(seed, self.tasks_per_gen, self.dim, self.device)
        tasks["type"] = torch.arange(self.tasks_per_gen, dtype=torch.int32,
                                     device=self.device) % N_FAMILIES
        return tasks

    def _draw_inner(self, seed: int) -> torch.Tensor:
        """Every inner generation's standard normals of every task, in one
        launch: ``(inner_gens, tasks, inner_pop, dim)``."""
        return torch.randn((self.inner_gens, self.tasks_per_gen, self.inner_pop, self.dim),
                           generator=generator(seed, self.device), device=self.device)

    def meta_fitness(self, flat: torch.Tensor, tasks: Task, noise: torch.Tensor) -> torch.Tensor:
        """The mean log10-gap over the tasks of each of ``flat``'s ``(B,
        214)`` parameter vectors."""
        return torch.mean(les_score(unravel(flat), tasks, noise), dim=-1)

    def step(self, ostate, seed: int):
        """One meta-step: ``(new outer state, next seed, meta-fitness of
        every candidate)``, nothing read back to the host."""
        seed, k_task, k_run = split_seed(seed, 3)
        tasks = self._draw_tasks(k_task)
        noise = self._draw_inner(k_run)
        cand, ostate = self.outer.ask(ostate)
        fit = self.meta_fitness(cand, tasks, noise)
        ostate = self.outer.tell(ostate, rank_based_fitness(fit))
        return ostate, seed, fit


def meta_train(seed: int = 0, outer_gens: int = OUTER_GENS, progress_every: int = 0,
               device: DeviceLike = None) -> Tuple[Params, torch.Tensor]:
    """Run the outer OpenES; returns (the trained parameter dict, its flat
    vector). ``progress_every`` prints the best candidate's mean log10-gap
    every that many meta-steps (a host read each time); 0 reads nothing."""
    trainer = MetaTrainer(seed, device=device)
    ostate, step_seed = trainer.init()
    for g in range(outer_gens):
        ostate, step_seed, fit = trainer.step(ostate, step_seed)
        if progress_every and (g + 1) % progress_every == 0:
            print(f"meta-gen {g + 1}/{outer_gens}: best mean log10-gap "
                  f"{float(fit.min()):.3f}", flush=True)
    flat = ostate.center
    return unravel(flat), flat


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Meta-train LES's parameters.")
    parser.add_argument("--out", type=Path, default=PARAMS_PATH,
                        help="where to save the flat vector (default: the bundled file)")
    parser.add_argument("--outer-gens", type=int, default=OUTER_GENS)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    params, flat = meta_train(outer_gens=args.outer_gens, progress_every=10, device=args.device)
    save_params(flat, args.out)
    print(f"saved {flat.shape[0]} params to {args.out}")
