"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version with the same contract. A wrapper takes the plain version only for
tensors on the CPU; on a CUDA tensor it launches its kernel or raises."""

from .rollout import (
    SoAEnv,
    cartpole_soa,
    fused_rollout,
    fused_rollout_plain,
    pendulum_soa,
)

__all__ = [
    "SoAEnv",
    "cartpole_soa",
    "fused_rollout",
    "fused_rollout_plain",
    "pendulum_soa",
]
