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
    import_stofnet, params_to_state_dict as jax_params_to_state_dict,
    state_dict_to_params,
)
from stofnet_tpu_torch.models import StofNet, stofnet_apply_fused
from stofnet_tpu_torch.models.torch_import import (
    load_stofnet, params_to_state_dict, save_torch_state_dict,
    stofnet_overrides,
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
    flax, the JAX package and PyYAML (absent on the machine with the card)
    out of sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "stofnet_tpu_torch").rglob("*.py"))
    assert {"stofnet_tpu_torch.train.steps", "stofnet_tpu_torch.train.loss",
            "stofnet_tpu_torch.train.checkpoint",
            "stofnet_tpu_torch.ops.gaussian",
            "stofnet_tpu_torch.serving.codecs",
            "stofnet_tpu_torch.serving.host",
            "stofnet_tpu_torch.serving.router",
            "stofnet_tpu_torch.serving.tcp",
            "stofnet_tpu_torch.cli.serve", "stofnet_tpu_torch.cli.export",
            "stofnet_tpu_torch.utils.config",
            "stofnet_tpu_torch.ops.int8",
            "stofnet_tpu_torch.models.int8",
            "stofnet_tpu_torch.cli.main", "stofnet_tpu_torch.data.chirp",
            "stofnet_tpu_torch.data.loader",
            "stofnet_tpu_torch.data.transforms",
            "stofnet_tpu_torch.data.synthetic",
            "stofnet_tpu_torch.native.__init__",
            "stofnet_tpu_torch.train.threshold",
            "stofnet_tpu_torch.utils.logging",
            "stofnet_tpu_torch.utils.plotting",
            "stofnet_tpu_torch.utils.profiling",
            "stofnet_tpu_torch.utils.natsort",
            "stofnet_tpu_torch.utils.zip_extract",
            "stofnet_tpu_torch.models.init",
            "stofnet_tpu_torch.models.batchnorm",
            "stofnet_tpu_torch.models.edsr1d",
            "stofnet_tpu_torch.models.espcn1d",
            "stofnet_tpu_torch.models.zonzini",
            "stofnet_tpu_torch.models.wave_unet",
            "stofnet_tpu_torch.models.kuleshov",
            "stofnet_tpu_torch.models.sincnet",
            "stofnet_tpu_torch.models.gradpeak",
            "stofnet_tpu_torch.models.registry",
            "stofnet_tpu_torch.ops.resample",
            "stofnet_tpu_torch.ops.hilbert",
            "stofnet_tpu_torch.ops.gradpeak",
            "stofnet_tpu_torch.models.attention",
            "stofnet_tpu_torch.models.sincnet_full",
            "stofnet_tpu_torch.ops.svd_filter",
            "stofnet_tpu_torch.ops.beamform",
            "stofnet_tpu_torch.data.pala",
            "stofnet_tpu_torch.scripts.pala_bmode_figure",
            "stofnet_tpu_torch.parallel.__init__",
            "stofnet_tpu_torch.parallel.array",
            "stofnet_tpu_torch.cli.array", "stofnet_tpu_torch.cli.sweep",
            "stofnet_tpu_torch.cli.report",
            "stofnet_tpu_torch.scripts.run_array",
            "stofnet_tpu_torch.scripts.bench_array",
            "stofnet_tpu_torch.scripts.run_chirp_sweep",
            "stofnet_tpu_torch.scripts.run_pala_sweeps"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'stofnet_tpu', 'yaml')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax():
    """No import of JAX, flax, the JAX package or PyYAML anywhere in the
    port's sources, lazy imports inside functions included."""
    banned = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|stofnet_tpu"
                        r"|yaml)(\.|\s|$)")
    files = list((REPO / "stofnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            assert not banned.match(line), (f, line)


@pytest.mark.parametrize("num_blocks", [13, 6])
def test_weights_init_is_orthogonal_with_jax_gains(num_blocks):
    """``weights_init=True``: each conv weight, flattened to (O, I*K), has
    orthonormal rows (or columns, where O > I*K) scaled by sqrt(2) on the
    activation layers and 1 on the residual schedule and conv_last, as
    JAX's module draws them (JAX's own draw is held to the same gains);
    biases and the SemiGlobalBlock keep the plain draw. Off by default."""
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    model = StofNet(num_blocks=num_blocks, weights_init=True,
                    generator=gen(), device="cpu")
    plain = StofNet(num_blocks=num_blocks, generator=gen(), device="cpu")
    variables = JaxStofNet(num_blocks=num_blocks, weights_init=True).init(
        jax.random.key(0), jnp.zeros((1, 1, 800)))
    ref = jax_params_to_state_dict(variables)
    residual = set(range(3, num_blocks - 1, 2)) | {num_blocks - 1}
    names = [f"conv{i}" for i in range(1, num_blocks)] + ["conv_last"]
    for i, name in enumerate(names, 1):
        gain = 1.0 if i in residual or name == "conv_last" else 2 ** 0.5
        for w in (model.state_dict()[f"{name}.weight"].double(),
                  torch.from_numpy(np.asarray(ref[f"{name}.weight"],
                                              np.float64))):
            m = w.reshape(w.shape[0], -1)
            g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
            eye = torch.eye(g.shape[0], dtype=torch.float64)
            torch.testing.assert_close(g, gain ** 2 * eye, atol=1e-5,
                                       rtol=0, msg=name)
    for k, v in plain.state_dict().items():
        if not (k.startswith("conv") and k.endswith(".weight")):
            assert torch.equal(model.state_dict()[k], v), k


def test_save_torch_state_dict_reads_in_jax(tmp_path):
    """The port's writer gives a .pth that JAX's ``import_stofnet`` reads
    back to the same tensors, f32 on the CPU."""
    model = StofNet(generator=torch.Generator().manual_seed(2), device="cpu")
    path = tmp_path / "m.pth"
    save_torch_state_dict(model.state_dict(), str(path))
    variables, overrides = import_stofnet(str(path))
    assert overrides == {"upsample_factor": 4}
    back = jax_params_to_state_dict(variables)
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy())
    sd, _ = load_stofnet(str(path))
    assert all(t.dtype == torch.float32 for t in sd.values())
