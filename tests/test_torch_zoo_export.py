"""The model zoo through the exporter and the daemon on the CPU:
``cli/export.py model=<family>`` (``resolve_zoo_variables_and_overrides``,
``serve.export_pipeline`` baked and ``export_pipeline_weightless``),
``serve.load_pipeline`` of those artifacts, and ``cli/serve.py`` serving
each family from its checkpoint (``model=``) and from its artifact
(``artifact=``).

Weights come from each JAX module's ``init``, cross through
``registry.variables_to_state_dict`` and are written as a reference
``.pth`` (``registry.export_checkpoint``); waveforms are made by numpy
from a seed. Tolerances: every artifact and every daemon row decodes bit
for bit as the port's ``make_pipeline`` on the CPU; in f32 against JAX's
``make_pipeline``, the heatmap families >= 0.99 of the slots within 1
sample, zonzini's and gradpeak's ToA to rtol 1e-4 (another order of f32
sums). Small sizes: 80 IQ samples at rf_scale_factor 10 (L=800; the
unet 3200 after its fold, zonzini 1600 for its 4 stages); Kuleshov at
L=800, its smallest length whose every stage has a positive width.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import build_model as jbuild
from stofnet_tpu.serve import make_pipeline as jpipeline
from stofnet_tpu_torch.cli import export as cli_export
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.registry import (
    REGRESSION, export_checkpoint, variables_to_state_dict,
)
from stofnet_tpu_torch.serve import (
    export_pipeline, load_pipeline, make_pipeline,
)
from stofnet_tpu_torch.serving import ServingClient

ZOO = ("edsr", "espcn", "zonzini", "unet", "sincnet", "kuleshov",
       "gradpeak")
FS, SAMPLES, RF = 1e6, 80, 10
# the exporter's build arguments of each family (cli/export.py keys)
ARGS = dict(dataset_kind="chirp", upsample_factor=4, rf_scale_factor=RF)
EXTRA = {"kuleshov": dict(sample_num=SAMPLES), "sincnet": dict(fs=FS)}
LENGTH = {"unet": SAMPLES * RF * 4, "zonzini": 1600}
ECHOES = 8


def length_of(name):
    return LENGTH.get(name, SAMPLES * RF)


def overrides_of(name):
    """The ``build_model`` arguments the exporter resolves for ``name``."""
    ov = dict(ARGS, **EXTRA.get(name, {}))
    if name == "unet":
        ov["n_layers"] = 2
    return ov


@functools.lru_cache(maxsize=None)
def jax_state(name):
    """(JAX variables, the port's state dict of them)."""
    if name == "gradpeak":
        return {}, {}
    jm, _ = jbuild(name, sample_num=SAMPLES, **{
        k: v for k, v in overrides_of(name).items()
        if k not in ("n_layers", "sample_num")})
    variables = jax.jit(jm.init)(jax.random.key(4),
                                 jnp.zeros((1, 1, length_of(name))))
    sd = variables_to_state_dict(name, variables)
    return variables, {k: torch.from_numpy(np.array(v))
                       for k, v in sd.items()}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """Each trainable family's JAX weights as a reference ``.pth``."""
    d = tmp_path_factory.mktemp("zoo_ckpts")
    for name in ZOO:
        if name != "gradpeak":
            export_checkpoint(name, jax_state(name)[1], d / f"{name}-j.pth")
    return d


def _cli_args(name, ckpt_dir):
    args = [f"model={name}", f"length={length_of(name)}",
            f"max_echoes={ECHOES}", "device=cpu", "th=Null",
            *(f"{k}={v}" for k, v in ARGS.items()),
            *(f"{k}={v}" for k, v in EXTRA.get(name, {}).items())]
    if name != "gradpeak":
        args += [f"model_file={name}-j", f"ckpt_dir={ckpt_dir}"]
    return args


def _direct(name, dtype, x):
    _, state = jax_state(name)
    return make_pipeline(state, overrides_of(name), model_name=name,
                         dtype=dtype, max_echoes=ECHOES, device="cpu")(x)


def _jax_close(name, got, x):
    variables, _ = jax_state(name)
    ov = {k: v for k, v in overrides_of(name).items() if k != "n_layers"}
    ref = np.asarray(jax.jit(jpipeline(
        variables or {"params": {}}, dict(ov, sample_num=SAMPLES),
        model_name=name, dtype=jnp.float32, max_echoes=ECHOES))(
        jnp.asarray(x)))
    got = got.numpy()
    assert got.shape == ref.shape
    if name in REGRESSION:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.mean(np.abs(got - ref) <= 1.0) >= 0.99


@pytest.mark.parametrize("bake", [True, False], ids=["baked", "weightless"])
@pytest.mark.parametrize("name", ZOO)
def test_cli_export_serves_every_family(name, bake, ckpt_dir, tmp_path):
    """``cli/export.py model=<name>``: the artifact (bf16 baked, or f32
    weightless with its sidecar) loads with no model code, keeps its
    batch polymorphic and decodes as ``make_pipeline`` bit for bit; f32
    against JAX's pipeline."""
    dtype = torch.bfloat16 if bake else torch.float32
    out = tmp_path / f"{name}.pt2"
    path = cli_export.main(_cli_args(name, ckpt_dir) + [
        "batch=b", f"out={out}", f"bake_weights={bake}",
        f"dtype={'bfloat16' if bake else 'float32'}"])
    assert (tmp_path / f"{name}.pt2.weights.npz").exists() != bake
    served = load_pipeline(path)
    assert served.in_specs[0].shape[-1] == length_of(name)
    assert isinstance(served.in_specs[0].shape[0], str)
    x = gate_batch(3, length_of(name), np.random.default_rng(1))
    got = served(x)
    want = _direct(name, dtype, x)
    # zonzini one ToA; gradpeak keeps one echo on chirp data (echo_max)
    assert got.shape == (3, 1 if name in REGRESSION else ECHOES)
    assert torch.equal(got, want)
    if not bake:
        _jax_close(name, got, x)


def test_baked_export_keeps_one_copy_of_the_weights():
    """A baked forward's constants (over Kuleshov's stage programs) are
    the state's own tensors (no second copy on the device), and the
    module's skeleton holds no data: the weights are drawn once, by the
    caller; the decode holds none."""
    _, state = jax_state("kuleshov")
    ptrs = {v.untyped_storage().data_ptr() for v in state.values()}
    artifact = export_pipeline(state, overrides_of("kuleshov"), "b",
                               length_of("kuleshov"), model_name="kuleshov",
                               dtype=torch.float32, device="cpu",
                               max_echoes=ECHOES)
    assert not [v for v in artifact.decode.constants.values()
                if isinstance(v, torch.Tensor) and v.numel() > 1000]
    consts = [v for p in artifact.stages for v in p.constants.values()
              if isinstance(v, torch.Tensor)]
    big = [v for v in consts if v.numel() > 1000]
    assert big and all(v.untyped_storage().data_ptr() in ptrs for v in big)
    assert sum(v.numel() for v in big) <= sum(v.numel()
                                              for v in state.values())


@pytest.mark.parametrize("extra,match", [
    ([], "sample_num="),
    (["sample_num=40"], "must equal the export length"),
])
def test_cli_export_kuleshov_needs_its_length(extra, match, ckpt_dir):
    args = [a for a in _cli_args("kuleshov", ckpt_dir)
            if not a.startswith("sample_num=")]
    with pytest.raises(SystemExit, match=match):
        cli_export.main(args + extra)


def test_cli_export_sincnet_needs_fs(ckpt_dir):
    args = [a for a in _cli_args("sincnet", ckpt_dir)
            if not a.startswith("fs=")]
    with pytest.raises(SystemExit, match="fs="):
        cli_export.main(args)


def test_zoo_resolution_picks_unet_depth_by_data_kind(ckpt_dir):
    """n_layers 2 on chirp, 10 on PALA or rat data (here the chirp
    checkpoint refuses the PALA depth: import_checkpoint holds it)."""
    base = {"model_file": "unet-j", "ckpt_dir": str(ckpt_dir)}
    state, ov = cli_export.resolve_zoo_variables_and_overrides(
        dict(base), "unet")
    assert ov["n_layers"] == 2 and ov["dataset_kind"] == "chirp"
    with pytest.raises(ValueError, match="n_layers=10"):
        cli_export.resolve_zoo_variables_and_overrides(
            dict(base, dataset_kind="pala"), "unet")
    _, ov = cli_export.resolve_zoo_variables_and_overrides({}, "gradpeak")
    assert ov["rf_scale_factor"] == 10 and ov["upsample_factor"] == 4


def _daemon_rows(args, x):
    hostd, server, port = build(args)
    try:
        with ServingClient(("127.0.0.1", port)) as c:
            return np.stack([np.asarray(c.infer(row[0])) for row in x])
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()


@pytest.mark.parametrize("name", ZOO)
def test_daemon_serves_every_family(name, ckpt_dir, tmp_path):
    """``cli/serve.py model=<name>`` from the checkpoint, and
    ``artifact=`` of its export: every row as ``make_pipeline``'s on that
    row (one client's requests run one at a time, as batches of 1)."""
    x = gate_batch(3, length_of(name), np.random.default_rng(2))
    want = np.concatenate([_direct(name, torch.float32, x[i:i + 1]).numpy()
                           for i in range(len(x))])
    serve_args = dict(max_batch=4, max_wait_ms=2, port=0, warmup=False)
    args = dict(cli_export.parse_args(_cli_args(name, ckpt_dir)),
                dtype="float32", **serve_args)
    np.testing.assert_array_equal(_daemon_rows(args, x), want)
    path = cli_export.main(_cli_args(name, ckpt_dir) + [
        "batch=b", f"out={tmp_path / 'a.pt2'}", "dtype=float32"])
    got = _daemon_rows(dict(artifact=str(path), **serve_args), x)
    np.testing.assert_array_equal(got, want)


def test_daemon_refuses_int8_for_the_zoo(ckpt_dir):
    args = cli_export.parse_args(_cli_args("edsr", ckpt_dir))
    with pytest.raises(SystemExit, match="model=stofnet only"):
        build(dict(args, int8_calib="x.npy", warmup=False))
