"""Meshes and data parallelism, and job-array execution (replaces
``stofnet_tpu/parallel/__init__.py``)."""

from stofnet_tpu_torch.parallel.mesh import (
    Mesh, batch_seq_sharding, batch_sharding, init_distributed, launch,
    make_mesh, replicate, shard_batch,
)
from stofnet_tpu_torch.parallel.array import (
    ArrayState, init_array_state, make_array_eval_step,
    make_array_train_step, make_threshold_sweep_step,
    member_optimizer_state, n_members, shard_members,
    stack_checkpoint_variables, stack_trees, unstack_tree,
)

__all__ = [
    "init_distributed", "make_mesh", "batch_sharding", "batch_seq_sharding",
    "replicate", "shard_batch", "Mesh", "launch",
    "ArrayState", "init_array_state", "make_array_eval_step",
    "make_array_train_step", "make_threshold_sweep_step",
    "member_optimizer_state", "n_members", "shard_members",
    "stack_checkpoint_variables", "stack_trees", "unstack_tree",
]
