from .es import *  # noqa: F401,F403
from .pso import *  # noqa: F401,F403
from . import es, pso

__all__ = ["es", "pso"]
