"""The port's serving daemon (``stofnet_tpu_torch/cli/serve.py``) and the
helpers it shares with the exporter (``cli/export.py``,
``utils/config.py``), on the CPU (``device=cpu``): built from a checkpoint
written by ``train/checkpoint.save_checkpoint``, answered over TCP, held
to the port's ``make_pipeline`` bit for bit and to JAX's within 1 sample;
the int8 route and an encoded input; the keys refused; argument parsing
against JAX's."""

import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.cli.export import parse_args as jax_parse_args
from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.serve import make_pipeline as jax_make_pipeline
from stofnet_tpu_torch.cli import export as cli_export
from stofnet_tpu_torch.cli.serve import build
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.serve import make_input_encoder, make_pipeline
from stofnet_tpu_torch.serving import ServingClient, codecs
from stofnet_tpu_torch.train.checkpoint import save_checkpoint
from stofnet_tpu_torch.utils.config import parse_value

LENGTH, MAX_BATCH = 800, 8


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A seeded random-init StofNet (the different-armadillo architecture)
    saved as a checkpoint of the port."""
    variables = JaxStofNet().init(jax.random.key(0),
                                  jnp.zeros((1, 1, LENGTH)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    d = tmp_path_factory.mktemp("ckpts")
    save_checkpoint(d / "armadillo-seed0.pt", state)
    return variables, state, d


def _args(d, **kw):
    args = {"model_file": "armadillo", "ckpt_dir": str(d),
            "length": LENGTH, "max_batch": MAX_BATCH, "max_wait_ms": 2,
            "port": 0, "device": "cpu", "max_echoes": 8}
    args.update(kw)
    return args


def _serve(args, fn):
    hostd, server, port = build(args)
    try:
        return fn(hostd, port)
    finally:
        server.shutdown()
        server.server_close()
        hostd.close()


def test_daemon_matches_make_pipeline(ckpt, capsys):
    """dtype=auto: the gate's choice is printed, every bucket is warmed
    before the server binds, and concurrent clients get the port's
    make_pipeline coords bit for bit (dtype as the gate chose)."""
    variables, state, d = ckpt
    x = gate_batch(6, LENGTH, np.random.default_rng(5))

    def run(hostd, port):
        assert hostd.stats()["bucket_counts"] == {1: 0, 2: 0, 4: 0, 8: 0}
        got = [None] * 6

        def client(i):
            with ServingClient(("127.0.0.1", port)) as c:
                got[i] = c.infer(x[i, 0])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        with ServingClient(("127.0.0.1", port)) as c:
            stats = c.stats()
        return np.stack(got), stats

    got, stats = _serve(_args(d), run)
    err = capsys.readouterr().err
    assert "dtype gate" in err and "warming up" in err
    dtype = torch.bfloat16 if "bf16 OK" in err else torch.float32
    want = make_pipeline(state, {"upsample_factor": 4}, dtype=dtype,
                         device="cpu", max_echoes=8)(x).numpy()
    np.testing.assert_array_equal(got, want)
    assert stats["requests"] == 6 and stats["waveforms"] == 6


def test_daemon_within_one_sample_of_jax(ckpt):
    """In f32, the daemon's coords lie within 1 sample of JAX's
    make_pipeline on the same weights."""
    variables, _, d = ckpt
    x = gate_batch(4, LENGTH, np.random.default_rng(6))
    ref = np.asarray(jax.jit(jax_make_pipeline(
        variables, {}, dtype=jnp.float32, max_echoes=8))(jnp.asarray(x)))

    def run(hostd, port):
        with ServingClient(("127.0.0.1", port)) as c:
            return c.infer(x[:, 0])

    got = _serve(_args(d, dtype="float32", warmup=False), run)
    assert got.shape == ref.shape == (4, 8)
    assert np.all(np.abs(got - ref) <= 1.0), (got, ref)
    assert (got != 0).any()


def test_int8_daemon_with_encoded_input(ckpt, tmp_path):
    """``int8_calib=`` a .npy and ``input_enc=s8c16``: the daemon serves
    the int8 route, and an ``s8c16`` wire's rows come back as the int8
    make_pipeline's coords on the decoded rows, encoded as the daemon
    encodes its input."""
    _, state, d = ckpt
    calib = gate_batch(8, LENGTH, np.random.default_rng(8))
    np.save(tmp_path / "calib.npy", calib)
    x = gate_batch(4, LENGTH, np.random.default_rng(9))
    rows = x[:, 0]
    wire_rows = codecs.decode_s8c(*codecs.encode_s8c(rows, 16))
    direct = make_pipeline(state, {"upsample_factor": 4},
                           dtype=torch.bfloat16, device="cpu", max_echoes=8,
                           int8_calib=calib, input_enc="s8c16")
    # the daemon encodes its input as make_input_encoder does
    want = direct(*make_input_encoder("s8c16")(wire_rows[:, None])).numpy()

    def run(hostd, port):
        assert hostd._pipeline.route(LENGTH) == "int8"
        with ServingClient(("127.0.0.1", port), wire="s8c16") as c:
            got = c.infer(rows)
        assert hostd._pipeline.calls["int8"] >= 1
        return got

    got = _serve(_args(d, int8_calib=str(tmp_path / "calib.npy"),
                       input_enc="s8c16", dtype="bfloat16",
                       warmup=False), run)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key,value,match", [
    ("mesh_sp", 3, "sample length 800 not divisible by mesh_sp=3"),
    ("mesh_dp", 3, "max_batch=8 must be divisible by the dp mesh size 3"),
    ("compile_cache", "cache", "compiles nothing"),
    ("model", "kuleshov", "sample_num="),
    ("bogus", 1, "unknown argument"),
    ("length", None, "length= is required"),
    ("model_file", None, "model_file="),
])
def test_daemon_refusals(ckpt, key, value, match):
    """A ``mesh_*`` key is given with ``mesh=True``."""
    _, _, d = ckpt
    args = _args(d, **{key: value})
    if key.startswith("mesh_"):
        args["mesh"] = True
    with pytest.raises(SystemExit, match=match):
        build(args)


def test_daemon_needs_a_card_or_device_cpu(ckpt):
    """Without ``device=cpu`` the daemon runs on the card, and without
    one it raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, d = ckpt
    args = _args(d)
    del args["device"]
    with pytest.raises(RuntimeError, match="CUDA"):
        build(args)


ARGV = ["model_file=different-armadillo", "ckpt_dir=ckpts", "length=8000",
        "th=Null", "th2=0.5", "max_echoes=64", "window_size=20",
        "int8_calib=x.npy", "int8_stack=4,8,10", "int8_stack2=[4,8,10]",
        "int8_eq_alpha=0.5", "int8_bias_correct=True", "warmup=False",
        "max_wait_ms=2.0", "max_pending=", "input_enc=s8c16",
        "dtype=auto", "port=7733", "host=127.0.0.1", "mesh=true",
        "num_features=32", "rate=1e-3", "scale=1.0e-3", "flag=yes"]


def test_parse_args_matches_jax():
    assert cli_export.parse_args(ARGV) == jax_parse_args(ARGV)
    with pytest.raises(SystemExit, match="key=value"):
        cli_export.parse_args(["length"])


@pytest.mark.parametrize("text", ["Null", "~", "True", "off", "0", "-7",
                                  "+3", "010", "-010", "1_000", "2.5", "1.",
                                  ".5", "+.5", "1_0.5", "1e-3", "1.0e+3",
                                  "s8c", "4,8,10", "[4, 8, 10]", "[]",
                                  "[a, 1.5, null]", "'quoted'", "09"])
def test_parse_value_matches_yaml(text):
    yaml = pytest.importorskip("yaml")
    want = yaml.safe_load(text)
    got = parse_value(text)
    assert got == want and type(got) is type(want)


def test_export_helpers(ckpt, tmp_path):
    """Checkpoint lookup (prefix in ckpt_dir, else a raw path), the
    architecture from the shapes with argument overrides winning, the
    dtype table, and the calibration and stack arguments."""
    _, state, d = ckpt
    path = cli_export._resolve_ckpt_path({"model_file": "armadillo",
                                          "ckpt_dir": str(d)})
    assert path.endswith("armadillo-seed0.pt")
    assert cli_export._resolve_ckpt_path({"model_file": "/x/y.pt",
                                          "ckpt_dir": str(d)}) == "/x/y.pt"
    got, ov = cli_export.resolve_variables_and_overrides(
        {"model_file": "armadillo", "ckpt_dir": str(d)})
    assert ov == {"upsample_factor": 4} and set(got) == set(state)
    _, ov = cli_export.resolve_variables_and_overrides(
        {"model_file": "armadillo", "ckpt_dir": str(d), "num_blocks": 13})
    assert ov == {"upsample_factor": 4, "num_blocks": 13}
    assert cli_export.resolve_dtype({}) == "auto"
    assert cli_export.resolve_dtype({"dtype": "bf16"}) is torch.bfloat16
    assert cli_export.resolve_dtype({"dtype": "float32"}) is torch.float32
    with pytest.raises(SystemExit, match="dtype="):
        cli_export.resolve_dtype({"dtype": "fp8"})
    assert cli_export.load_calib({}) is None
    np.save(tmp_path / "bad.npy", np.zeros((2, 800), np.float32))
    with pytest.raises(SystemExit, match=r"\(B, 1, L\)"):
        cli_export.load_calib({"int8_calib": str(tmp_path / "bad.npy")})
    cfg = cli_export.load_stack_cfg({"int8_calib": "x.npy",
                                     "int8_stack": "4,8,10",
                                     "int8_eq_alpha": 0.5,
                                     "int8_bias_correct": True})
    assert cfg == {"int8_stack_layers": (4, 8, 10), "int8_eq_alpha": 0.5,
                   "int8_bias_correct": True}
    assert cli_export.load_stack_cfg({"int8_calib": "x.npy",
                                      "int8_stack": [4, 8]})[
        "int8_stack_layers"] == (4, 8)
    with pytest.raises(SystemExit, match="requires int8_calib"):
        cli_export.load_stack_cfg({"int8_stack": "4"})
