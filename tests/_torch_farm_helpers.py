"""Module-level (hence picklable) env, policy and fault-injecting worker for
the port's rollout-farm tests and ``chip_smoke.py``'s farm path: worker
processes unpickle them by qualified name. Imports neither ``jax`` nor the
JAX package, so it runs where only the port is installed."""

from __future__ import annotations

import os
import time
from typing import Tuple

import numpy as np

from evox_tpu_torch.problems.neuroevolution.hostenv import NumpyCartPoleVec
from evox_tpu_torch.problems.neuroevolution.policy import flat_mlp_policy
from evox_tpu_torch.problems.neuroevolution.process_farm import (
    DEFAULT_AUTHKEY,
    _handshake,
    _recv,
    _send,
)


class ScalarCartPole:
    """One gymnasium-API CartPole episode over the numpy dynamics; the info
    dict carries ``aux`` = 1.0 a step (an objective for ``mo_keys``)."""

    def __init__(self, max_steps: int = 200):
        self.vec = NumpyCartPoleVec(num_envs=1, max_steps=max_steps)

    def reset(self, seed=0):
        return self.vec.reset(seed)[0], {}

    def step(self, action):
        obs, r, term, trunc = self.vec.step(np.asarray(action)[None])
        return obs[0], float(r[0]), bool(term[0]), bool(trunc[0]), {"aux": 1.0}


class RenderCartPole(ScalarCartPole):
    """:class:`ScalarCartPole` with a ``render`` that returns a frame."""

    def render(self):
        return np.zeros((32, 32, 3), dtype=np.uint8)


class NaNEnv:
    """:class:`ScalarCartPole` whose reward turns NaN after
    ``poison_after`` steps: a numerically poisoned simulator."""

    def __init__(self, poison_after: int = 0, max_steps: int = 200):
        self._base = ScalarCartPole(max_steps=max_steps)
        self.poison_after = poison_after
        self._steps = 0

    def reset(self, seed=0):
        self._steps = 0
        return self._base.reset(seed)

    def step(self, action):
        obs, r, term, trunc, info = self._base.step(action)
        self._steps += 1
        if self._steps > self.poison_after:
            r = float("nan")
        return obs, r, term, trunc, info


D_IN, D_H, D_OUT = 4, 8, 2
_APPLY, DIM = flat_mlp_policy(D_IN, D_H, D_OUT)


def flat_policy(params, obs):
    """The flat-genome MLP 4 -> 8 -> 2 of ``flat_mlp_policy`` (picklable by
    name; the JAX package's test helper has the same layout)."""
    return _APPLY(params, obs)


def chaos_worker_main(address: Tuple[str, int], authkey: bytes = DEFAULT_AUTHKEY,
                      mode: str = "kill", after: int = 0) -> None:
    """A farm worker that completes the handshake, register and setup, then
    misbehaves on a rollout request, after ``after`` served well:
    ``"kill"`` hard-exits mid-generation (``os._exit``), ``"hang"`` never
    answers, ``"drop"`` closes the connection without an answer."""
    import socket

    import torch

    from evox_tpu_torch.problems.neuroevolution.rollout_farm import _Worker

    torch.set_num_threads(1)
    sock = socket.create_connection(address)
    try:
        _handshake(sock, authkey, server=False)
        _send(sock, {"type": "register"})
        setup = _recv(sock)
        worker = _Worker(setup["env_creator"], setup["mo_keys"])
        policy = torch.func.vmap(setup["policy"])
        served = 0
        while True:
            try:
                msg = _recv(sock)
            except (ConnectionError, OSError):
                return
            if msg["type"] == "shutdown":
                return
            if msg["type"] == "ping":
                _send(sock, {"type": "pong"})
                continue
            if served < after:
                worker.rollout(policy, msg["subpop"], msg["seed"], msg["cap"])
                rewards, mo, lengths = worker.results()
                _send(sock, {"type": "result", "slice": msg.get("slice"), "rewards": rewards,
                             "mo": mo, "lengths": lengths})
                served += 1
                continue
            if mode == "kill":
                os._exit(1)
            elif mode == "hang":
                time.sleep(3600)
            elif mode == "drop":
                sock.close()
                return
            else:
                raise ValueError(f"unknown chaos mode: {mode!r}")
    finally:
        try:
            sock.close()
        except OSError:
            pass


def spawn_chaos_worker(address: Tuple[str, int], authkey: bytes = DEFAULT_AUTHKEY,
                       mode: str = "kill", after: int = 0):
    """Start one :func:`chaos_worker_main` in a spawned process (daemon)."""
    import multiprocessing as mp

    p = mp.get_context("spawn").Process(target=chaos_worker_main,
                                        args=(address, authkey, mode, after), daemon=True)
    p.start()
    return p


def reap(procs, timeout: float = 30.0) -> list:
    """Join every process under ``timeout``; kill the ones still alive.
    Returns the exit codes."""
    codes = []
    for p in procs:
        p.join(timeout=timeout)
        if p.is_alive():
            p.kill()
            p.join(timeout=timeout)
        codes.append(p.exitcode)
    return codes
