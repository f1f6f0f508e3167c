"""Classic single-objective benchmark functions — the port of
``evox_tpu/problems/numerical/basic.py``. Each is a function over the last
axis plus a ``Problem`` whose ``evaluate`` applies it to the population on
whatever device the population lies."""

from __future__ import annotations

import math

import torch

from ...core.problem import Problem


def ackley_func(x: torch.Tensor, a: float = 20.0, b: float = 0.2, c: float = 2.0 * math.pi) -> torch.Tensor:
    return (
        -a * torch.exp(-b * torch.sqrt(torch.mean(x**2, dim=-1)))
        - torch.exp(torch.mean(torch.cos(c * x), dim=-1))
        + a
        + math.e
    )


def rastrigin_func(x: torch.Tensor) -> torch.Tensor:
    return 10.0 * x.shape[-1] + torch.sum(x**2 - 10.0 * torch.cos(2.0 * math.pi * x), dim=-1)


def sphere_func(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x**2, dim=-1)


def griewank_func(x: torch.Tensor) -> torch.Tensor:
    i = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)
    return 1.0 + torch.sum(x**2, dim=-1) / 4000.0 - torch.prod(torch.cos(x / torch.sqrt(i)), dim=-1)


def rosenbrock_func(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(
        100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2, dim=-1
    )


def schwefel_func(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    return 418.9828872724338 * d - torch.sum(x * torch.sin(torch.sqrt(torch.abs(x))), dim=-1)


class _FuncProblem(Problem):
    _func = None

    def evaluate(self, state, pop):
        return type(self)._func(pop), state


class Ackley(_FuncProblem):
    _func = staticmethod(ackley_func)


class Rastrigin(_FuncProblem):
    _func = staticmethod(rastrigin_func)


class Sphere(_FuncProblem):
    _func = staticmethod(sphere_func)


class Griewank(_FuncProblem):
    _func = staticmethod(griewank_func)


class Rosenbrock(_FuncProblem):
    _func = staticmethod(rosenbrock_func)


class Schwefel(_FuncProblem):
    _func = staticmethod(schwefel_func)
