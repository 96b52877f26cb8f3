"""TCP front for the serving host: cross-process waveform inference (a
copy of ``stofnet_tpu/serving/tcp.py``; the same bytes on the wire).

A stdlib-only length-prefixed binary protocol, deliberately boring, so
any language can speak it without a codegen step:

request  : magic ``b"SFN1"`` + ``<II`` (k, L) + k*L float32 (LE)
request 2: magic ``b"SFN2"`` + ``<BBII`` (wire, param, k, L) + payload
           wire 0: k*L float32 (same rows as SFN1)
           wire 1: k*L bfloat16 (the round-to-nearest-even top 16 bits
                   of each float32, LE uint16) — HALF the request bytes;
                   lossless for a bf16 forward, whose first op
                   performs the identical cast anyway
           wire 2: per waveform: 1 float32 scale + L int8 (value =
                   scale * q, scale = max|row|/127) — a QUARTER of the
                   request bytes; mirrors the int8-SGB path's own dynamic
                   per-waveform activation quantization (models/int8.py)
           wire 3: per waveform: 1 float32 scale + L int16 (scale =
                   max|row|/32767) — half the bytes at 256× finer codes
                   than wire 2 (serving/codecs.py encode_s16)
           wire 4: per waveform: n float32 per-CHUNK scales + L int8,
                   n = the header's ``param`` byte (1..255, must divide
                   L) — a quiet chunk keeps a fine scale where wire 2
                   rides the loudest echo's (serving/codecs.py
                   encode_s8c)
           The ``param`` byte is 0 for wires 0-3.
response : ``<iI``  (status, m)
           status 0: m = E (coords per waveform), then k*E float32
           status 1: m = byte length of a UTF-8 error message, then it
           status 2: m = byte length of a UTF-8 JSON document, then it

stats    : magic ``b"SFNS"`` (no further header) → status-2 response with
           the host's live stats (occupancy, latency percentiles, bucket
           counts; per-length when the daemon routes several lengths) —
           production monitoring without stopping the daemon

Responses stay float32 regardless of the request wire: coords are sample
indices up to L*upsample, and bfloat16's 8-bit mantissa would corrupt an
index ≥256 by up to 32 samples at L=8000 — the response is tiny (k*E
floats) so there is nothing to win. Compaction targets the request
payload, which dominates the wire (a (128, 8000) request is 4 MB f32,
2 MB bf16, 1 MB int8).

A connection carries any number of request/response cycles (connection
reuse amortizes the TCP handshake at high request rates); requests from
MANY connections coalesce into shared device batches via ``ServingHost``.
The server is a ``ThreadingTCPServer``: one OS thread per connection
blocks on its Future while the single dispatcher thread feeds the card —
the thread count is bounded by open connections, not request rate.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Optional, Tuple

import numpy as np

from stofnet_tpu_torch.serving.codecs import DEFAULT_CHUNKS, parse_s8c  # noqa: F401 (DEFAULT_CHUNKS re-exported)
from stofnet_tpu_torch.serving.host import ServingHost

MAGIC = b"SFN1"
MAGIC2 = b"SFN2"
STATS_MAGIC = b"SFNS"
_REQ_HDR = struct.Struct("<II")
_REQ2_HDR = struct.Struct("<BBII")
_RSP_HDR = struct.Struct("<iI")
# sanity bound on k*L so a corrupt/hostile header cannot make the server
# attempt a multi-GB read (128 Mi samples = 512 MB payload)
_MAX_SAMPLES = 128 * 1024 * 1024

WIRE_F32, WIRE_BF16, WIRE_INT8, WIRE_INT16, WIRE_INT8C = 0, 1, 2, 3, 4
# "s8c<n>" (e.g. "s8c16") selects wire 4 with n chunks; bare "s8c" uses
# codecs.DEFAULT_CHUNKS (re-exported here for compatibility)
WIRE_CODES = {"f32": WIRE_F32, "bf16": WIRE_BF16, "int8": WIRE_INT8,
              "int16": WIRE_INT16, "s16": WIRE_INT16}
_KNOWN_WIRES = (WIRE_F32, WIRE_BF16, WIRE_INT8, WIRE_INT16, WIRE_INT8C)


def parse_wire(wire: str) -> Tuple[int, int]:
    """Wire name → (wire code, param byte). ``param`` is the chunk count
    for ``s8c<n>`` and 0 otherwise (one shared spelling parse with the
    input encodings: codecs.parse_s8c)."""
    if wire in WIRE_CODES:
        return WIRE_CODES[wire], 0
    n = parse_s8c(wire)
    if n is not None:
        return WIRE_INT8C, n
    raise ValueError(f"wire must be one of {sorted(WIRE_CODES)} or "
                     f"'s8c<n>', got {wire!r}")


def payload_nbytes(wire: int, k: int, length: int, param: int = 0) -> int:
    """Request payload size in bytes for ``wire`` (see module docstring)."""
    if wire == WIRE_F32:
        return 4 * k * length
    if wire == WIRE_BF16:
        return 2 * k * length
    if wire == WIRE_INT8:
        return k * (4 + length)
    if wire == WIRE_INT16:
        return k * (4 + 2 * length)
    if wire == WIRE_INT8C:
        return k * (4 * param + length)
    raise ValueError(f"unknown wire code {wire}")


def encode_rows(rows: np.ndarray, wire: int, param: int = 0) -> bytes:
    """(k, L) float32 rows → request payload bytes for ``wire``."""
    rows = np.ascontiguousarray(rows, "<f4")
    if wire == WIRE_F32:
        return rows.tobytes()
    if wire == WIRE_BF16:
        u = rows.view("<u4")
        # round-to-nearest-even truncation to the top 16 bits — the exact
        # rounding an f32→bf16 cast performs, so a bf16 forward sees
        # bit-identical inputs either way
        h = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
             >> np.uint32(16)).astype("<u2")
        return h.tobytes()
    if wire == WIRE_INT8:
        k, length = rows.shape
        amax = np.max(np.abs(rows), axis=-1)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype("<f4")
        q = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
        buf = np.empty((k, 4 + length), np.uint8)
        buf[:, :4] = scale.view(np.uint8).reshape(k, 4)
        buf[:, 4:] = q.view(np.uint8)
        return buf.tobytes()
    if wire == WIRE_INT16:
        from stofnet_tpu_torch.serving.codecs import encode_s16

        k, length = rows.shape
        codes, scales = encode_s16(rows)
        buf = np.empty((k, 4 + 2 * length), np.uint8)
        buf[:, :4] = scales.view(np.uint8).reshape(k, 4)
        buf[:, 4:] = codes.view(np.uint8)
        return buf.tobytes()
    if wire == WIRE_INT8C:
        from stofnet_tpu_torch.serving.codecs import encode_s8c

        k, length = rows.shape
        codes, scales = encode_s8c(rows, param)
        buf = np.empty((k, 4 * param + length), np.uint8)
        buf[:, :4 * param] = scales.view(np.uint8).reshape(k, 4 * param)
        buf[:, 4 * param:] = codes.view(np.uint8)
        return buf.tobytes()
    raise ValueError(f"unknown wire code {wire}")


def decode_payload(payload: bytes, wire: int, k: int, length: int,
                   param: int = 0) -> np.ndarray:
    """Request payload bytes → (k, 1, L) float32 waveforms."""
    if wire == WIRE_F32:
        x = np.frombuffer(payload, "<f4")
    elif wire == WIRE_BF16:
        h = np.frombuffer(payload, "<u2").astype("<u4")
        x = (h << np.uint32(16)).view("<f4")
    elif wire == WIRE_INT8:
        buf = np.frombuffer(payload, np.uint8).reshape(k, 4 + length)
        scale = buf[:, :4].copy().view("<f4")
        x = buf[:, 4:].view(np.int8).astype("<f4") * scale
    elif wire == WIRE_INT16:
        from stofnet_tpu_torch.serving.codecs import decode_s16

        buf = np.frombuffer(payload, np.uint8).reshape(k, 4 + 2 * length)
        scales = buf[:, :4].copy().view("<f4")[:, 0]
        codes = buf[:, 4:].copy().view("<i2")
        x = decode_s16(codes, scales)
    elif wire == WIRE_INT8C:
        from stofnet_tpu_torch.serving.codecs import decode_s8c

        buf = np.frombuffer(payload, np.uint8).reshape(k, 4 * param + length)
        scales = buf[:, :4 * param].copy().view("<f4")
        codes = buf[:, 4 * param:].view(np.int8)
        x = decode_s8c(codes, scales)
    else:
        raise ValueError(f"unknown wire code {wire}")
    return x.reshape(k, 1, length)


def _recv_exact(sock_file, n: int) -> Optional[bytes]:
    """Read exactly n bytes from a file-like socket; None on clean EOF at
    a message boundary; raises on a mid-message EOF."""
    buf = sock_file.read(n)
    if not buf:
        return None
    if len(buf) != n:
        raise ConnectionError(f"short read: wanted {n} bytes, got {len(buf)}")
    return buf


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        while True:
            magic = _recv_exact(self.rfile, len(MAGIC))
            if magic is None:
                return  # client closed between requests
            if magic == STATS_MAGIC:
                import json

                data = json.dumps(self.server.host.stats()).encode()
                self.wfile.write(_RSP_HDR.pack(2, len(data)) + data)
                self.wfile.flush()
                continue
            if magic == MAGIC2:
                head = _recv_exact(self.rfile, _REQ2_HDR.size)
                if head is None:
                    raise ConnectionError("EOF inside request header")
                wire, param, k, length = _REQ2_HDR.unpack(head)
                if wire not in _KNOWN_WIRES:
                    self._send_error(f"unknown wire code {wire}")
                    return  # payload length unknown; framing is lost
                if wire == WIRE_INT8C and (
                        param < 1 or length % max(param, 1)):
                    # reject BEFORE the payload read: an invalid chunk
                    # count leaves the payload length meaningless, and
                    # validating divisibility here also restores the
                    # _MAX_SAMPLES byte bound (with param | length the
                    # payload is <= 5*k*length bytes; an unchecked
                    # param=255, length=1 header could otherwise demand
                    # a ~137 GB buffered read)
                    self._send_error("s8c wire needs a chunk count (param "
                                     "byte) that divides the waveform "
                                     "length")
                    return  # payload length unknown; framing is lost
            elif magic == MAGIC:
                head = _recv_exact(self.rfile, _REQ_HDR.size)
                if head is None:
                    raise ConnectionError("EOF inside request header")
                wire, param = WIRE_F32, 0
                k, length = _REQ_HDR.unpack(head)
            else:
                self._send_error(f"bad magic {magic!r}")
                return  # framing is lost; drop the connection
            if not (1 <= k * length <= _MAX_SAMPLES):
                self._send_error(f"refusing request of {k}x{length} samples")
                return
            payload = _recv_exact(self.rfile,
                                  payload_nbytes(wire, k, length, param))
            if payload is None:
                raise ConnectionError("EOF inside request payload")
            try:
                x = decode_payload(payload, wire, k, length, param)
            except ValueError as e:
                # e.g. an s8c chunk count that does not divide L — the
                # payload was fully read, so framing is intact: report
                # in-band and keep the connection serving
                self._send_error(f"{type(e).__name__}: {e}")
                continue
            try:
                out = np.asarray(self.server.host.infer(x), "<f4")
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send_error(f"{type(e).__name__}: {e}")
                continue
            self.wfile.write(_RSP_HDR.pack(0, out.shape[1]))
            self.wfile.write(out.tobytes())
            self.wfile.flush()

    def _send_error(self, msg: str) -> None:
        data = msg.encode()
        self.wfile.write(_RSP_HDR.pack(1, len(data)) + data)
        self.wfile.flush()


class ServingTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address: Tuple[str, int], host: ServingHost):
        super().__init__(address, _Handler)
        self.host = host


def start_server(host: ServingHost, address: Tuple[str, int] = ("127.0.0.1", 0)
                 ) -> Tuple[ServingTCPServer, threading.Thread, int]:
    """Bind (port 0 = ephemeral), serve on a daemon thread; returns
    (server, thread, bound_port). Stop with ``server.shutdown()``."""
    server = ServingTCPServer(address, host)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="stofnet-serving-tcp")
    thread.start()
    return server, thread, server.server_address[1]


class ServingClient:
    """Blocking client for the protocol above. One in-flight request per
    client; open one client per concurrent caller (or pool them).

    ``wire``: request payload encoding — ``"f32"`` (default; speaks the
    original SFN1 frame bit-for-bit), ``"bf16"`` (half the request bytes;
    lossless for a bf16 forward), ``"int16"``/``"s16"`` (half,
    256× finer codes than int8), ``"s8c"``/``"s8c<n>"`` (a quarter;
    per-chunk scales, n must divide L — the recommended compact wire),
    or ``"int8"`` (a quarter; per-waveform scaled). Responses are always
    f32."""

    def __init__(self, address: Tuple[str, int], timeout: float = 120.0,
                 wire: str = "f32"):
        self._wire, self._param = parse_wire(wire)
        self._sock = socket.create_connection(address, timeout=timeout)
        self._f = self._sock.makefile("rwb")

    def infer(self, x: np.ndarray) -> np.ndarray:
        """(L,) → (E,); (k, L) or (k, 1, L) → (k, E)."""
        x = np.asarray(x, "<f4")
        squeeze = x.ndim == 1
        rows = x.reshape((1, -1) if squeeze else (x.shape[0], -1))
        k, length = rows.shape
        if self._wire == WIRE_F32:
            # the original frame — kept bit-identical so every existing
            # client of the SFN1 protocol stays valid
            self._f.write(MAGIC + _REQ_HDR.pack(k, length) + rows.tobytes())
        else:
            self._f.write(MAGIC2
                          + _REQ2_HDR.pack(self._wire, self._param, k, length)
                          + encode_rows(rows, self._wire, self._param))
        self._f.flush()
        head = _recv_exact(self._f, _RSP_HDR.size)
        if head is None:
            raise ConnectionError("server closed the connection")
        status, m = _RSP_HDR.unpack(head)
        body = _recv_exact(self._f, (4 * k * m) if status == 0 else m)
        if status != 0:
            raise RuntimeError(f"server error: "
                               f"{(body or b'').decode(errors='replace')}")
        if body is None:
            raise ConnectionError("EOF inside response payload")
        out = np.frombuffer(body, "<f4").reshape(k, m)
        return out[0] if squeeze else out

    def stats(self) -> dict:
        """Query the daemon's live serving stats (occupancy, latency
        percentiles, bucket counts; per-length for routed daemons)."""
        import json

        self._f.write(STATS_MAGIC)
        self._f.flush()
        head = _recv_exact(self._f, _RSP_HDR.size)
        if head is None:
            raise ConnectionError("server closed the connection")
        status, m = _RSP_HDR.unpack(head)
        body = _recv_exact(self._f, m)
        if status == 1:
            raise RuntimeError(f"server error: "
                               f"{(body or b'').decode(errors='replace')}")
        if status != 2 or body is None:
            raise ConnectionError(f"bad stats response (status={status})")
        return json.loads(body.decode())

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
