"""The port's driver against the JAX package's for the BatchNorm families of
the model zoo, unet and sincnet, on the CPU: one epoch from one shared
``.pth`` and ``evaluate=True`` from it, with the stand-in, helpers and
tolerances of ``tests/test_torch_cli_main_zoo.py`` (the epoch's
``val_loss`` at rtol 5e-3, see ``VAL_RTOL``); the ``.pth`` that the
port exports (its running statistics included) reads in JAX as the run's
final variables.
"""

import numpy as np
import pytest
import torch

from stofnet_tpu.models.registry import import_checkpoint as jimport
from stofnet_tpu_torch.models import variables_to_state_dict
from tests.test_torch_cli_main_zoo import (
    assert_train_pair, eval_pair, make_dirs, make_root, train_pair,
)


# the epoch's val_loss runs on the running statistics after 5 AdamW steps.
# The conv biases ahead of a train-mode BatchNorm have a zero gradient, so
# each side holds rounding noise there, which AdamW scales by
# lr / (|g| + eps): a move of a fraction of lr whose direction differs
# between the sides, and which the running means take up in part.
# Measured: 1.8e-3 (unet) and 1.1e-3 (sincnet) relative, with the train
# losses within 1e-4 and the decoded metrics equal.
VAL_RTOL = 5e-3


@pytest.fixture(scope="module")
def chirp_root(tmp_path_factory):
    return make_root(tmp_path_factory)


@pytest.mark.parametrize("name", ["unet", "sincnet"])
def test_train_and_evaluate_match_jax(tmp_path, chirp_root, name):
    dirs = make_dirs(tmp_path / name, name)
    out = train_pair(dirs, chirp_root, name)
    assert_train_pair(out, val_rtol=VAL_RTOL)
    summary = out["port"][0]
    final = torch.load(summary["checkpoint"], weights_only=True)["model"]
    got = variables_to_state_dict(name, jimport(name, summary["export_pth"]))
    stats = [k for k in final if k.endswith("running_var")]
    assert stats and all(not torch.equal(final[k], torch.ones_like(final[k]))
                         for k in stats)  # the epoch moved them
    for k, v in final.items():
        if k.endswith("num_batches_tracked"):
            continue  # flax keeps no count
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    eval_pair(dirs, chirp_root, name)
