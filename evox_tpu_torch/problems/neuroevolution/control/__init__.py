from . import envs, walker
from .envs import EnvSpec, cartpole, pendulum
from .walker import WALKER_DEFAULTS, chain_walker, walker_config

__all__ = [
    "EnvSpec",
    "WALKER_DEFAULTS",
    "cartpole",
    "chain_walker",
    "envs",
    "pendulum",
    "walker",
    "walker_config",
]
