from . import envs, walker
from .brax_adapter import brax_env
from .envs import ENVS, EnvSpec, acrobot, cartpole, make, mountain_car, pendulum
from .walker import WALKER_DEFAULTS, chain_walker, walker_config

envs.ENVS["chain_walker"] = chain_walker  # available through make()

__all__ = [
    "ENVS",
    "EnvSpec",
    "WALKER_DEFAULTS",
    "acrobot",
    "brax_env",
    "cartpole",
    "chain_walker",
    "envs",
    "make",
    "mountain_car",
    "pendulum",
    "walker",
    "walker_config",
]
