from ._native import NativeVectorEnv, native_available
from .control import envs
from .hostenv import HostEnvProblem, HostVectorEnv, NumpyCartPoleVec, envpool_make
from .policy import flat_mlp_policy, mlp_policy
from .process_farm import FarmDegradedError, ProcessRolloutFarm, spawn_local_workers
from .rollout import CapEpisode, ObsNormalizer, PolicyRolloutProblem, RolloutState, Trajectory
from .rollout_farm import HostRolloutFarm

__all__ = [
    "CapEpisode",
    "FarmDegradedError",
    "HostEnvProblem",
    "HostRolloutFarm",
    "HostVectorEnv",
    "NativeVectorEnv",
    "NumpyCartPoleVec",
    "ObsNormalizer",
    "PolicyRolloutProblem",
    "ProcessRolloutFarm",
    "RolloutState",
    "Trajectory",
    "envpool_make",
    "envs",
    "flat_mlp_policy",
    "mlp_policy",
    "native_available",
    "spawn_local_workers",
]
