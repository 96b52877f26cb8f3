"""The port's serving layer (``stofnet_tpu_torch/serving``, copies of the JAX
package's host, TCP front, router and codecs) and its encoded inputs
(``serve.make_input_encoder`` / ``make_pipeline(input_enc=...)``), on the
CPU: the codecs and the wire bit for bit against JAX's, the host's
coalescing and padding invisible to a real pipeline of the port, and the
wire spoken by JAX's ``ServingClient`` and ``examples/serving_client.c``."""

import shutil
import socket
import struct
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.serve import make_input_encoder as jax_encoder
from stofnet_tpu.serving import codecs as jcodecs
from stofnet_tpu.serving import tcp as jtcp
from stofnet_tpu.serving import ServingClient as JaxServingClient
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.serve import (
    make_input_encoder, make_pipeline, parse_input_enc,
)
from stofnet_tpu_torch.serving import (
    LengthRouter, Overloaded, ServingClient, ServingHost, batch_buckets,
    codecs, decode_payload, encode_rows, start_server, tcp,
)

LENGTH, ECHOES = 800, 8
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def state():
    variables = JaxStofNet().init(jax.random.key(0),
                                  jnp.zeros((1, 1, LENGTH)))
    return {k: torch.tensor(v)
            for k, v in params_to_state_dict(variables).items()}


@pytest.fixture(scope="module")
def live_pipeline(state):
    """The port's serving pipeline on the CPU (bf16, the fused route's
    plain versions), returning host numpy as the daemon's does."""
    pipe = make_pipeline(state, {}, max_echoes=ECHOES, device="cpu")
    return lambda x: pipe(x).numpy()


def _rows(rng, k=5, length=256):
    rows = (rng.standard_normal((k, length))
            * 10.0 ** rng.integers(-3, 4, (k, 1))).astype(np.float32)
    rows[3] = 0.0  # an all-zero waveform: the scale guards
    rows[1, :16] = 0.0  # an all-zero chunk
    return rows


def test_codecs_match_jax(rng):
    """encode/decode of s16 and s8c<n>, and their spellings, bit for bit
    against the JAX package's codecs."""
    rows = _rows(rng)
    for port, jax_ in ((codecs.encode_s16(rows), jcodecs.encode_s16(rows)),
                       (codecs.encode_s8c(rows, 16),
                        jcodecs.encode_s8c(rows, 16)),
                       (codecs.encode_s8c(rows, 1),
                        jcodecs.encode_s8c(rows, 1))):
        for a, b in zip(port, jax_):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    c16, s16 = jcodecs.encode_s16(rows)
    np.testing.assert_array_equal(codecs.decode_s16(c16, s16),
                                  jcodecs.decode_s16(c16, s16))
    c8, s8 = jcodecs.encode_s8c(rows, 16)
    np.testing.assert_array_equal(codecs.decode_s8c(c8, s8),
                                  jcodecs.decode_s8c(c8, s8))
    for name in ("s8c", "s8c1", "s8c16", "s8c255", "s16", "f32", "s8cx"):
        assert codecs.parse_s8c(name) == jcodecs.parse_s8c(name)
    with pytest.raises(ValueError, match="1..255"):
        codecs.parse_s8c("s8c256")
    with pytest.raises(ValueError, match="divide"):
        codecs.chunk_len(250, 16)
    assert codecs.DEFAULT_CHUNKS == jcodecs.DEFAULT_CHUNKS


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "s16", "s8c16",
                                  "s8c"])
def test_wire_matches_jax(rng, wire):
    """The same request bytes as the JAX package's wire, and the same
    decoded rows."""
    rows = _rows(rng)
    code, param = tcp.parse_wire(wire)
    assert (code, param) == jtcp.parse_wire(wire)
    payload = encode_rows(rows, code, param)
    assert payload == jtcp.encode_rows(rows, code, param)
    assert len(payload) == tcp.payload_nbytes(code, 5, 256, param)
    np.testing.assert_array_equal(
        decode_payload(payload, code, 5, 256, param),
        jtcp.decode_payload(payload, code, 5, 256, param))


def test_bf16_encoder_matches_jax(rng):
    """The bf16 input encoder's codes bit for bit against JAX's
    (``ml_dtypes``): round to nearest even, ties, subnormals and
    infinities included; and against the bf16 wire's own rounding."""
    x = rng.standard_normal((4, 1, 256)).astype(np.float32)
    special = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, 1e-40,
                        3.4e38, np.inf, -np.inf, 2.0 ** -126],
                       np.float32)
    x[0, 0, :special.size] = special
    (got,) = make_input_encoder("bf16")(x)
    (want,) = jax_encoder("bf16")(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    wire = decode_payload(encode_rows(x[:, 0], tcp.WIRE_BF16),
                          tcp.WIRE_BF16, 4, 256)
    np.testing.assert_array_equal(got.float().numpy(), wire)


@pytest.mark.parametrize("enc", ["s16", "s8c16", "s8c"])
def test_encoders_match_jax(rng, enc):
    x = rng.standard_normal((3, 1, 320)).astype(np.float32)
    for a, b in zip(make_input_encoder(enc)(x), jax_encoder(enc)(x)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert parse_input_enc(enc)[0] in ("s16", "s8c")


@pytest.mark.parametrize("enc", ["bf16", "s16", "s8c16"])
def test_encoded_pipeline_is_the_decoded_input(state, rng, enc):
    """``make_pipeline(input_enc=enc)`` on the encoder's codes gives the
    bits of the f32 pipeline on the numpy decode of the same codes (bf16:
    on the input itself, the forward's own cast absorbs the encode)."""
    x = gate_batch(2, LENGTH, rng)
    base = make_pipeline(state, {}, max_echoes=ECHOES, device="cpu")
    pipe = make_pipeline(state, {}, max_echoes=ECHOES, device="cpu",
                         input_enc=enc)
    inputs = make_input_encoder(enc)(x)
    if enc == "bf16":
        want = base(x)
    elif enc == "s16":
        want = base(codecs.decode_s16(inputs[0].reshape(2, -1),
                                      inputs[1].reshape(-1))[:, None])
    else:
        want = base(codecs.decode_s8c(inputs[0].reshape(2, -1),
                                      inputs[1].reshape(2, -1))[:, None])
    assert torch.equal(pipe(*inputs), want)
    assert pipe.calls == {"fused": 1, "module": 0}
    with pytest.raises(ValueError, match="input_enc"):
        parse_input_enc("f16")


class RecordingPipeline:
    """Test double: records the batch shapes; output row i = the first
    ECHOES samples of row i."""

    def __init__(self, gate=None, fail_on=None):
        self.shapes, self.calls = [], 0
        self.gate, self.fail_on = gate, fail_on

    def __call__(self, x):
        self.calls += 1
        self.shapes.append(x.shape)
        if self.gate is not None and self.calls == 1:
            self.gate.wait(10.0)
        if self.fail_on is not None and x.shape[0] == self.fail_on:
            raise RuntimeError("injected device fault")
        return np.asarray(x)[:, 0, :ECHOES]


def test_batch_buckets():
    assert batch_buckets(128) == (1, 2, 4, 8, 16, 32, 64, 128)
    assert batch_buckets(12) == (1, 2, 4, 8, 12)
    with pytest.raises(ValueError):
        batch_buckets(0)


def test_host_matches_direct_pipeline_exactly(live_pipeline):
    """Concurrent mixed-size requests through the host decode to the bits
    of each request run alone: coalescing and zero padding are invisible,
    and the batches the pipeline sees are bucket-shaped."""
    rng = np.random.default_rng(0)
    reqs = [gate_batch(int(rng.integers(1, 4)), LENGTH, rng)
            for _ in range(8)]
    want = [live_pipeline(r) for r in reqs]
    shapes = []

    def recording(x):
        shapes.append(x.shape)
        return live_pipeline(x)

    with ServingHost(recording, LENGTH, max_batch=8,
                     max_wait_ms=20.0) as host:
        futures = [None] * len(reqs)

        def client(lo, hi):
            for i in range(lo, hi):
                futures[i] = host.submit(reqs[i])

        threads = [threading.Thread(target=client, args=(i * 2, i * 2 + 2))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        got = [f.result(60.0) for f in futures]
    for g, w, r in zip(got, want, reqs):
        assert g.shape == (r.shape[0], ECHOES)
        np.testing.assert_array_equal(g, w)
    assert all(s[0] in batch_buckets(8) for s in shapes)
    s = host.stats()
    assert s["requests"] == 8 and s["waveforms"] == sum(len(r) for r in reqs)
    assert 0 < s["occupancy"] <= 1.0 and "latency_p99_ms" in s


def test_same_row_alone_padded_and_full(live_pipeline):
    """One row decodes to the same bits at B=1, padded into a bucket and
    in a full batch."""
    x = gate_batch(8, LENGTH, np.random.default_rng(1))
    full = live_pipeline(x)
    pad = np.concatenate([x[:3], np.zeros((1, 1, LENGTH), np.float32)])
    np.testing.assert_array_equal(live_pipeline(x[:1])[0], full[0])
    np.testing.assert_array_equal(live_pipeline(pad)[:3], full[:3])


def test_coalescing_many_singles_few_calls():
    gate = threading.Event()
    pipe = RecordingPipeline(gate=gate)
    host = ServingHost(pipe, LENGTH, max_batch=8, max_wait_ms=0.0)
    try:
        x = np.zeros(LENGTH, np.float32)
        first = host.submit(x)
        while pipe.calls == 0:
            time.sleep(0.001)
        futs = [host.submit(x) for _ in range(8)]
        gate.set()
        first.result(30.0)
        for f in futs:
            assert f.result(30.0).shape == (ECHOES,)
        assert pipe.calls == 2 and pipe.shapes[1] == (8, 1, LENGTH)
    finally:
        gate.set()
        host.close()


def test_errors_fan_out_and_close_drains():
    with ServingHost(RecordingPipeline(fail_on=2), LENGTH, max_batch=2,
                     max_wait_ms=100.0) as host:
        bad = host.submit(np.zeros((2, LENGTH), np.float32))
        with pytest.raises(RuntimeError, match="injected device fault"):
            bad.result(30.0)
        assert host.infer(np.zeros(LENGTH, np.float32), 30.0).shape == (
            ECHOES,)
        with pytest.raises(ValueError, match="length"):
            host.submit(np.zeros(LENGTH + 1, np.float32))
        with pytest.raises(ValueError, match="max_batch"):
            host.submit(np.zeros((3, LENGTH), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        host.submit(np.zeros(LENGTH, np.float32))
    pipe = RecordingPipeline()
    with ServingHost(pipe, LENGTH, max_batch=8) as host:
        host.warmup()
    assert [s[0] for s in pipe.shapes] == [1, 2, 4, 8]


def test_admission_control_rejects_overload():
    gate = threading.Event()
    host = ServingHost(RecordingPipeline(gate=gate), LENGTH, max_batch=2,
                       max_pending=3, max_wait_ms=0.0)
    try:
        x = np.zeros(LENGTH, np.float32)
        futs = [host.submit(x) for _ in range(3)]
        with pytest.raises(Overloaded, match="max_pending=3"):
            host.submit(x)
        assert host.stats()["rejected"] == 1
        gate.set()
        for f in futs:
            assert f.result(timeout=30.0).shape == (ECHOES,)
        assert host.submit(x).result(timeout=30.0).shape == (ECHOES,)
        assert host.stats()["pending"] == 0
    finally:
        gate.set()
        host.close()
    with pytest.raises(ValueError, match="max_pending=2 < max_batch=4"):
        ServingHost(RecordingPipeline(), LENGTH, max_batch=4, max_pending=2)


def test_length_router_routes_and_rejects():
    pipes = {400: RecordingPipeline(), 800: RecordingPipeline()}
    hosts = {n: ServingHost(p, n, max_batch=4) for n, p in pipes.items()}
    router = LengthRouter(hosts)
    assert router.lengths == (400, 800)
    rng = np.random.default_rng(0)
    for n in (400, 800, 400):
        x = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_array_equal(router.infer(x, timeout=30.0),
                                      x[:ECHOES])
    assert pipes[400].calls == 2 and pipes[800].calls == 1
    with pytest.raises(ValueError, match=r"600.*\(400, 800\)"):
        router.submit(np.zeros(600, np.float32))
    s = router.stats()
    assert s["requests"] == 3 and set(s["per_length"]) == {400, 800}
    router.close()
    with pytest.raises(RuntimeError):
        hosts[400].submit(np.zeros(400, np.float32))
    h = ServingHost(RecordingPipeline(), 400, max_batch=2)
    try:
        with pytest.raises(ValueError, match="router key"):
            LengthRouter({800: h})
    finally:
        h.close()


def test_tcp_round_trip(live_pipeline):
    """Concurrent clients over sockets reusing connections, bit for bit
    the direct pipeline; the squeeze path; in-band errors keep the
    connection; the stats query; compact wires equal the pipeline on the
    decoded payload; JAX's client speaks to the port's server."""
    rng = np.random.default_rng(2)
    with ServingHost(live_pipeline, LENGTH, max_batch=8,
                     max_wait_ms=10.0) as host:
        server, _, port = start_server(host)
        try:
            reqs = [gate_batch(int(rng.integers(1, 4)), LENGTH, rng)
                    for _ in range(6)]
            want = [live_pipeline(r) for r in reqs]
            got = [None] * len(reqs)

            def client(lo, hi):
                with ServingClient(("127.0.0.1", port)) as c:
                    for i in range(lo, hi):
                        got[i] = c.infer(reqs[i][:, 0, :])

            threads = [threading.Thread(target=client,
                                        args=(i * 2, i * 2 + 2))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)

            x = reqs[0][:, 0]
            with ServingClient(("127.0.0.1", port)) as c:
                np.testing.assert_array_equal(c.infer(x[0]), want[0][0])
                with pytest.raises(RuntimeError, match="length"):
                    c.infer(np.zeros(LENGTH + 1, np.float32))
                np.testing.assert_array_equal(c.infer(x[0]), want[0][0])
                s = c.stats()
                assert s["requests"] >= 7 and "occupancy" in s
            for wire in ("bf16", "s16", "s8c16", "int8"):
                code, param = tcp.parse_wire(wire)
                decoded = decode_payload(encode_rows(x, code, param), code,
                                         len(x), LENGTH, param)
                with ServingClient(("127.0.0.1", port), wire=wire) as c:
                    np.testing.assert_array_equal(c.infer(x),
                                                  live_pipeline(decoded))
            with JaxServingClient(("127.0.0.1", port), wire="s8c") as c:
                np.testing.assert_array_equal(
                    c.infer(x), live_pipeline(decode_payload(
                        encode_rows(x, tcp.WIRE_INT8C, 16), tcp.WIRE_INT8C,
                        len(x), LENGTH, 16)))
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=30.0) as sock:
                sock.sendall(b"SFN2" + struct.pack("<BBII", 9, 0, 1, LENGTH))
                status, m = struct.unpack("<iI",
                                          sock.recv(8, socket.MSG_WAITALL))
                assert status == 1
                assert b"unknown wire" in sock.recv(m, socket.MSG_WAITALL)
        finally:
            server.shutdown()
            server.server_close()


def test_c_client_speaks_the_protocol(live_pipeline, tmp_path):
    """``examples/serving_client.c`` round-trips a waveform (f32 and the
    compact wires) and the stats query against the port's daemon, coords
    bit for bit the direct pipeline's; a server error exits 2."""
    cc = shutil.which("gcc")
    cmd = [cc, "-O2"] if cc else [shutil.which("g++"), "-O2", "-x", "c"]
    if cmd[0] is None:
        pytest.skip("no C compiler available")
    exe = tmp_path / "serving_client"
    subprocess.run([*cmd, "-o", str(exe),
                    str(REPO / "examples" / "serving_client.c"), "-lm"],
                   check=True)
    x = gate_batch(1, LENGTH, np.random.default_rng(7))[0, 0]
    with ServingHost(live_pipeline, LENGTH, max_batch=4) as host:
        server, _, port = start_server(host)
        try:
            def run(length, wire=None, data=x):
                argv = [str(exe), "127.0.0.1", str(port), str(length)]
                return subprocess.run(argv + ([wire] if wire else []),
                                      input=data.tobytes(),
                                      capture_output=True, timeout=120)

            p = run(LENGTH)
            assert p.returncode == 0, p.stderr
            got = np.array([float(v) for v in p.stdout.split()], np.float32)
            np.testing.assert_array_equal(got, live_pipeline(x[None, None])[0])
            assert b'"requests": 1' in p.stderr
            for wire, code in (("bf16", tcp.WIRE_BF16),
                               ("int8", tcp.WIRE_INT8),
                               ("s16", tcp.WIRE_INT16)):
                p = run(LENGTH, wire)
                assert p.returncode == 0, p.stderr
                got = np.array([float(v) for v in p.stdout.split()],
                               np.float32)
                want = live_pipeline(decode_payload(
                    encode_rows(x[None], code), code, 1, LENGTH))[0]
                np.testing.assert_array_equal(got, want)
            bad = run(LENGTH // 2, data=x[:LENGTH // 2])
            assert bad.returncode == 2 and b"server error" in bad.stderr
        finally:
            server.shutdown()
            server.server_close()
