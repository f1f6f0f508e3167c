from . import envs
from .envs import EnvSpec, cartpole, pendulum

__all__ = ["EnvSpec", "cartpole", "envs", "pendulum"]
