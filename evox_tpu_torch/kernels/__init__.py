"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version with the same contract. A wrapper takes the plain version only for
tensors on the CPU; on a CUDA tensor it launches its kernel or raises."""

from .digest import digest_leaves, digest_leaves_plain, digest_work
from .dominance import (
    column_popcount,
    dominance_work,
    pack_dominator_rows,
    packed_dominance,
    packed_dominance_batched,
    packed_dominance_batched_reference,
    packed_dominance_reference,
    packed_dominance_rows,
    packed_dominance_rows_reference,
)
from .rollout import (
    SoAEnv,
    acrobot_soa,
    cartpole_soa,
    fused_rollout,
    fused_rollout_plain,
    mountain_car_soa,
    pendulum_soa,
    rollout_work,
)
from .rollout_mlp import (
    PlaneEnv,
    chain_walker_planes,
    fused_mlp_rollout,
    fused_mlp_rollout_plain,
    fused_rollout_analysis,
    mlp_rollout_work,
)
from .smallmm import smallmm_plain, smallmm_work
from .topk import (
    default_use_kernel,
    partial_topk,
    partial_topk_reference,
    topk_work,
    total_order_key,
)

__all__ = [
    "PlaneEnv",
    "SoAEnv",
    "acrobot_soa",
    "cartpole_soa",
    "chain_walker_planes",
    "column_popcount",
    "default_use_kernel",
    "digest_leaves",
    "digest_leaves_plain",
    "digest_work",
    "dominance_work",
    "fused_mlp_rollout",
    "fused_mlp_rollout_plain",
    "fused_rollout",
    "fused_rollout_analysis",
    "fused_rollout_plain",
    "mlp_rollout_work",
    "mountain_car_soa",
    "pack_dominator_rows",
    "packed_dominance",
    "packed_dominance_batched",
    "packed_dominance_batched_reference",
    "packed_dominance_reference",
    "packed_dominance_rows",
    "packed_dominance_rows_reference",
    "partial_topk",
    "partial_topk_reference",
    "pendulum_soa",
    "rollout_work",
    "smallmm_plain",
    "smallmm_work",
    "topk_work",
    "total_order_key",
]
