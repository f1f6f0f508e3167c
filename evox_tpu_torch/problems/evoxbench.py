"""EvoXBench NAS benchmarks as problems — the port of
``evox_tpu/problems/evoxbench.py``.

The ``evoxbench`` package hosts the benchmark databases, and its
``evaluate`` is noisy: each call seeds numpy's global generator with a
seed of its own, drawn from a seed chain, the reference's scheme. The problem
runs on the host (``jittable = False``): numpy candidates in, numpy
fitness out. The suites are import-guarded: constructing one without
``evoxbench`` raises ImportError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.problem import Problem
from ..utils.common import split_seed


class EvoXBenchProblem(Problem):
    """An ``evoxbench`` benchmark object as a host problem. A workflow
    keeps no state for a host problem, so the seed chain lives on the
    object: ``init(seed)`` starts it, and each evaluation takes its numpy
    seed from it through :meth:`_eval_seed`."""

    jittable = False

    def __init__(self, benchmark):
        self.benchmark = benchmark
        self.n_objs = benchmark.evaluator.n_objs
        self.lb = np.asarray(benchmark.search_space.lb, dtype=np.float32)
        self.ub = np.asarray(benchmark.search_space.ub, dtype=np.float32)
        self._seed = 0

    def fit_shape(self, pop_size: int) -> Tuple[int, ...]:
        return (pop_size, self.n_objs)

    def init(self, seed: Optional[int] = None) -> None:
        self._seed = 0 if seed is None else seed
        return None

    def _eval_seed(self) -> int:
        """This evaluation's numpy seed in ``[0, 2**31 - 1)``; advances the
        chain."""
        self._seed, use = split_seed(self._seed)
        return use % (2**31 - 1)

    def evaluate(self, state, pop):
        np.random.seed(self._eval_seed())
        return self.benchmark.evaluate(np.asarray(pop)).astype(np.float32), state


def _load_suite(name: str):
    try:
        from evoxbench import test_suites
    except ImportError as e:
        raise ImportError(
            "the `evoxbench` package (and its benchmark databases) is "
            "required for NAS benchmark problems"
        ) from e
    return getattr(test_suites, name)


class C10MOP(EvoXBenchProblem):
    """CIFAR-10 NAS multi-objective problems 1-9."""

    def __init__(self, problem_id: int):
        if not (isinstance(problem_id, int) and 1 <= problem_id <= 9):
            raise ValueError("C10MOP problem_id must be an int in [1, 9]")
        super().__init__(_load_suite("c10mop")(problem_id))


class CitySegMOP(EvoXBenchProblem):
    """Cityscapes segmentation NAS problems 1-15."""

    def __init__(self, problem_id: int):
        if not (isinstance(problem_id, int) and 1 <= problem_id <= 15):
            raise ValueError("CitySegMOP problem_id must be an int in [1, 15]")
        super().__init__(_load_suite("citysegmop")(problem_id))


class IN1kMOP(EvoXBenchProblem):
    """ImageNet-1k NAS problems 1-9."""

    def __init__(self, problem_id: int):
        if not (isinstance(problem_id, int) and 1 <= problem_id <= 9):
            raise ValueError("IN1kMOP problem_id must be an int in [1, 9]")
        super().__init__(_load_suite("in1kmop")(problem_id))
