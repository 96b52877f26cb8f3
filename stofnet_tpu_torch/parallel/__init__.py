"""Job-array execution (replaces the array half of
``stofnet_tpu/parallel/__init__.py``; the mesh half comes with
``parallel/mesh.py``)."""

from stofnet_tpu_torch.parallel.array import (
    ArrayState, init_array_state, make_array_eval_step,
    make_array_train_step, make_threshold_sweep_step,
    member_optimizer_state, n_members, stack_checkpoint_variables,
    stack_trees, unstack_tree,
)

__all__ = [
    "ArrayState", "init_array_state", "make_array_eval_step",
    "make_array_train_step", "make_threshold_sweep_step",
    "member_optimizer_state", "n_members", "stack_checkpoint_variables",
    "stack_trees", "unstack_tree",
]
