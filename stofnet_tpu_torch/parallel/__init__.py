"""Meshes, data and sequence parallelism, and job-array execution
(replaces ``stofnet_tpu/parallel/__init__.py``).

``parallel/array.py`` imports ``train/steps.py``, which imports
``parallel/seq.py``; so its names load on first use (:func:`__getattr__`),
and importing this package imports no train layer.
"""

import importlib

from stofnet_tpu_torch.parallel.mesh import (
    Mesh, batch_seq_sharding, batch_sharding, init_distributed, launch,
    make_mesh, replicate, shard_batch,
)
from stofnet_tpu_torch.parallel.seq import (
    SeqPlan, local_forward, model_arch, reach, split_windows, widen, window,
)

_ARRAY = (
    "ArrayState", "init_array_state", "make_array_eval_step",
    "make_array_train_step", "make_threshold_sweep_step",
    "member_optimizer_state", "n_members", "shard_members",
    "stack_checkpoint_variables", "stack_trees", "unstack_tree",
)

__all__ = [
    "init_distributed", "make_mesh", "batch_sharding", "batch_seq_sharding",
    "replicate", "shard_batch", "Mesh", "launch",
    "reach", "window", "widen", "split_windows", "model_arch", "SeqPlan",
    "local_forward", *_ARRAY,
]


def __getattr__(name: str):
    """The names of ``parallel/array.py``, loaded on first use."""
    if name in _ARRAY:
        return getattr(importlib.import_module(
            "stofnet_tpu_torch.parallel.array"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
