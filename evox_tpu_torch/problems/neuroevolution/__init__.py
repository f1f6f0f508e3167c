from .control import envs
from .policy import flat_mlp_policy, mlp_policy
from .rollout import PolicyRolloutProblem, RolloutState

__all__ = ["PolicyRolloutProblem", "RolloutState", "envs", "flat_mlp_policy", "mlp_policy"]
