from .de import *  # noqa: F401,F403
from .es import *  # noqa: F401,F403
from .pso import *  # noqa: F401,F403
from . import de, es, pso

__all__ = ["de", "es", "pso"]
