"""The port's StofNet module and fused forward against the JAX package's, on
the CPU in f32, with weights from a JAX random init moved across by
``params_to_state_dict``; the weight bridge; the port's import isolation."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models.fused import stofnet_apply_fused as jax_fused
from stofnet_tpu.models.torch_import import (
    params_to_state_dict as jax_params_to_state_dict, state_dict_to_params,
)
from stofnet_tpu_torch.models import StofNet, stofnet_apply_fused
from stofnet_tpu_torch.models.torch_import import (
    load_stofnet, params_to_state_dict, stofnet_overrides,
)

from tests import reference

REPO = Path(__file__).resolve().parents[1]


def _init(cfg, cin, length):
    variables = JaxStofNet(**cfg).init(jax.random.key(0),
                                       jnp.zeros((1, cin, length)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    return variables, state


def _assert_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * np.abs(ref).max())


def _module_case(cfg, cin, length, batch, rng):
    variables, state = _init(cfg, cin, length)
    model = StofNet(in_channels=cin, device="cpu", **cfg)
    model.load_state_dict(state, strict=True)
    x = rng.standard_normal((batch, cin, length)).astype(np.float32)
    ref = np.asarray(JaxStofNet(**cfg).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _assert_close(got, ref)


@pytest.mark.parametrize("length,batch", [(800, 2), (8000, 1)])
def test_module_matches_jax(rng, length, batch):
    _module_case({}, 1, length, batch, rng)


@pytest.mark.parametrize("draw", range(4))
def test_module_matches_jax_config_space(draw):
    """Draws of the reference option space (tests/reference.py): widths,
    depths, kernel sizes with the hard-coded conv1/conv_last paddings,
    SGB scales incl. none, in_channels > 1."""
    rng = np.random.default_rng(draw)
    cfg, cin, length = reference.sample_stofnet_config(rng)
    _module_case(cfg, cin, length, 2, rng)


def test_module_keeps_odd_padding_error():
    """L=811 pools to 10 rows; the 11-sample remainder cannot be split
    evenly, and both frameworks refuse it."""
    variables, state = _init({}, 1, 800)
    model = StofNet(device="cpu")
    model.load_state_dict(state)
    with pytest.raises(ValueError, match="must be even"):
        JaxStofNet().apply(variables, jnp.zeros((1, 1, 811)))
    with pytest.raises(ValueError, match="must be even"):
        model(torch.zeros((1, 1, 811)))


@pytest.mark.parametrize("fused_stack", [True, False])
def test_fused_forward_matches_jax(rng, fused_stack):
    variables, state = _init({}, 1, 800)
    x = rng.standard_normal((2, 1, 800)).astype(np.float32)
    ref = np.asarray(jax_fused(variables, jnp.asarray(x), dtype=None,
                               interpret=True, fused_stack=fused_stack))
    got = stofnet_apply_fused(state, torch.from_numpy(x), dtype=None,
                              fused_stack=fused_stack).numpy()
    assert got.shape == (2, 1, 3200)
    _assert_close(got, ref)


def test_state_dict_round_trip(tmp_path):
    """flax variables -> port state dict -> .pth -> load_stofnet -> flax."""
    variables, _ = _init({}, 1, 800)
    sd = params_to_state_dict(variables)
    ref_sd = jax_params_to_state_dict(variables)
    assert sd.keys() == ref_sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref_sd[k], err_msg=k)

    path = tmp_path / "stofnet.pth"
    torch.save({k: torch.tensor(v)
                for k, v in sd.items()}, path)
    loaded, overrides = load_stofnet(str(path))
    assert overrides == {"upsample_factor": 4}
    back = state_dict_to_params({k: v.numpy() for k, v in loaded.items()})
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path_, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path_]),
                                      np.asarray(leaf))


def test_overrides_infer_architecture():
    cfg = dict(upsample_factor=2, num_features=16, num_blocks=6,
               kernel_sizes=[5, 3, 1], semi_global_scale=20)
    _, state = _init(cfg, 2, 400)
    assert stofnet_overrides(state) == dict(cfg, in_channels=2)
    _, state = _init(dict(semi_global_scale=1), 1, 100)
    assert stofnet_overrides(state) == {"upsample_factor": 4,
                                        "semi_global_scale": 1}


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) leaves JAX,
    flax and the JAX package out of sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "stofnet_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'stofnet_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax():
    """No import of JAX, flax or the JAX package anywhere in the port's
    sources, lazy imports inside functions included."""
    banned = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|stofnet_tpu)"
                        r"(\.|\s|$)")
    files = list((REPO / "stofnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            assert not banned.match(line), (f, line)
