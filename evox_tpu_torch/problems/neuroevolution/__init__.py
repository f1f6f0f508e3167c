from .control import envs
from .policy import flat_mlp_policy, mlp_policy
from .rollout import CapEpisode, ObsNormalizer, PolicyRolloutProblem, RolloutState, Trajectory

__all__ = [
    "CapEpisode",
    "ObsNormalizer",
    "PolicyRolloutProblem",
    "RolloutState",
    "Trajectory",
    "envs",
    "flat_mlp_policy",
    "mlp_policy",
]
