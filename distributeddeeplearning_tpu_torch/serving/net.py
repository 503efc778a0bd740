"""Wire framing for the cross-process serving fleet (stdlib only; the
frames are byte for byte those of the JAX package's ``serving/net.py``).

One frame = a 4-byte big-endian unsigned length followed by that many
bytes of payload. Two payload kinds share the stream:

    +----------------+---------------------------+
    | len (u32, BE)  |  payload: UTF-8 JSON body |
    +----------------+---------------------------+

    +----------------+-------+--------------+-----------+------------+
    | len (u32, BE)  | magic | meta_len u32 | meta JSON | raw body   |
    +----------------+-------+--------------+-----------+------------+

The second is the BINARY KV frame (:class:`KVFrame`) that carries paged
KV-block bytes for a prefill→decode handoff: ``magic`` is
:data:`KV_MAGIC` (its first byte, 0x00, can never begin JSON text, so
the two kinds are discriminated from the payload's first bytes alone),
``meta`` is a small JSON header (request wire form, chain digests,
per-block byte ``sizes``), and ``body`` is the concatenated raw block
bytes — pool rows shipped bitwise, so an int8-quantized pool's ~3.2x
size win carries straight onto the wire.

The codec is deliberately boring — stdlib sockets, stdlib json — and it
lives apart from any socket so the framing itself is unit-testable on
plain byte buffers (tests/test_torch_serving_net.py): :class:`FrameDecoder`
accepts arbitrary partial reads and yields complete objects as they
close, which is exactly the shape a nonblocking ``recv`` loop produces.

Every malformed input path raises :class:`ProtocolError` BY NAME —
oversized declared length (before buffering a byte of the payload),
payload that is not valid JSON, a frame that closes mid-payload, a KV
frame whose declared block sizes overrun or underrun its actual body. A
router or worker treats any ``ProtocolError`` on a connection as that
peer being gone: there is no resync point inside a corrupted
length-prefixed stream.

``MAX_FRAME_BYTES`` bounds a single frame (default 16 MiB): the largest
legitimate frames are a heartbeat digest summary and one KV handoff
part (the sender chunks long chains across parts —
``serving.handoff_blocks_per_frame``). The bound is what turns a
corrupt or hostile length word into a typed error instead of an OOM.
"""

from __future__ import annotations

import json
import select
import socket
import struct

MAX_FRAME_BYTES = 16 << 20

_LEN = struct.Struct(">I")

# First payload bytes of a binary KV frame. JSON payloads always start
# with a printable character, never 0x00, so four bytes of payload decide
# the kind with zero ambiguity (and version the binary layout: "KV1").
KV_MAGIC = b"\x00KV1"


class ProtocolError(RuntimeError):
    """Typed wire-protocol violation: oversized frame, malformed JSON
    payload, or a stream that ended mid-frame. Not retryable — the
    stream has no resync point, so the connection is dead."""


def encode_frame(obj, *, max_bytes: int = MAX_FRAME_BYTES) -> bytes:
    """One length-prefixed frame for ``obj`` (compact JSON)."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > max_bytes:
        raise ProtocolError(
            f"frame payload {len(payload)} bytes exceeds max_bytes "
            f"{max_bytes} — refusing to send an unreceivable frame"
        )
    return _LEN.pack(len(payload)) + payload


class KVFrame:
    """One decoded binary KV frame: a JSON ``meta`` header plus the raw
    concatenated block bytes in ``body``. ``meta['sizes']`` gives each
    block's byte length in order, so :meth:`blocks` re-slices the body
    without copying the stream twice. The decoder has already verified
    that the sizes sum exactly to ``len(body)``."""

    __slots__ = ("meta", "body")

    def __init__(self, meta: dict, body: bytes):
        self.meta = meta
        self.body = body

    def blocks(self) -> list[bytes]:
        out, off = [], 0
        for size in self.meta["sizes"]:
            out.append(self.body[off:off + size])
            off += size
        return out

    def __repr__(self) -> str:  # keep test failures readable
        return (f"KVFrame(op={self.meta.get('op')!r}, "
                f"blocks={len(self.meta.get('sizes', []))}, "
                f"body={len(self.body)}B)")


def encode_kv_frame(meta: dict, body: bytes, *,
                    max_bytes: int = MAX_FRAME_BYTES) -> bytes:
    """One length-prefixed BINARY frame: ``KV_MAGIC | meta_len(u32,BE) |
    meta JSON | body``. ``meta['sizes']`` is required and must sum to
    ``len(body)`` — encode enforces the same invariant decode checks, so
    a torn handoff can never be framed as valid."""
    sizes = meta.get("sizes")
    if not isinstance(sizes, list) or sum(sizes) != len(body):
        raise ProtocolError(
            f"kv frame meta sizes {sizes!r} do not cover body "
            f"({len(body)} bytes)"
        )
    meta_json = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    payload_len = len(KV_MAGIC) + 4 + len(meta_json) + len(body)
    if payload_len > max_bytes:
        raise ProtocolError(
            f"kv frame payload {payload_len} bytes exceeds max_bytes "
            f"{max_bytes} — chunk the chain across more parts "
            "(serving.handoff_blocks_per_frame)"
        )
    return b"".join((_LEN.pack(payload_len), KV_MAGIC,
                     _LEN.pack(len(meta_json)), meta_json, body))


def _parse_kv_payload(payload: bytes) -> KVFrame:
    head = len(KV_MAGIC) + _LEN.size
    if len(payload) < head:
        raise ProtocolError(
            f"kv frame payload {len(payload)} bytes is shorter than its "
            f"{head}-byte header"
        )
    (meta_len,) = _LEN.unpack_from(payload, len(KV_MAGIC))
    if head + meta_len > len(payload):
        raise ProtocolError(
            f"kv frame meta length {meta_len} overruns the "
            f"{len(payload)}-byte payload"
        )
    try:
        meta = json.loads(payload[head:head + meta_len].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(f"malformed kv frame meta: {exc}") from exc
    sizes = meta.get("sizes") if isinstance(meta, dict) else None
    if (not isinstance(meta, dict) or not isinstance(sizes, list)
            or not all(isinstance(s, int) and s >= 0 for s in sizes)):
        raise ProtocolError(f"kv frame meta missing block sizes: {meta!r}")
    body = payload[head + meta_len:]
    if sum(sizes) != len(body):
        raise ProtocolError(
            f"kv frame truncated mid-block: declared sizes sum to "
            f"{sum(sizes)} bytes but body holds {len(body)}"
        )
    return KVFrame(meta, body)


class FrameDecoder:
    """Incremental frame parser over arbitrary byte chunks.

    ``feed(data)`` buffers ``data`` and returns every frame that is now
    complete (possibly none, possibly several) — short reads, split
    length words, and multiple frames per chunk all just work. State is
    a single bytearray; the declared length is validated against
    ``max_bytes`` as soon as the 4-byte prefix is readable, BEFORE the
    payload is buffered.
    """

    def __init__(self, *, max_bytes: int = MAX_FRAME_BYTES):
        self.max_bytes = int(max_bytes)
        self._buf = bytearray()

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> list:
        self._buf.extend(data)
        out = []
        while True:
            if len(self._buf) < _LEN.size:
                break
            (n,) = _LEN.unpack_from(self._buf)
            if n > self.max_bytes:
                raise ProtocolError(
                    f"declared frame length {n} exceeds max_bytes "
                    f"{self.max_bytes} — corrupt stream or hostile peer"
                )
            if len(self._buf) < _LEN.size + n:
                break
            payload = bytes(self._buf[_LEN.size:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            if payload[:len(KV_MAGIC)] == KV_MAGIC:
                out.append(_parse_kv_payload(payload))
                continue
            try:
                out.append(json.loads(payload.decode("utf-8")))
            except (ValueError, UnicodeDecodeError) as exc:
                raise ProtocolError(
                    f"malformed JSON frame payload ({n} bytes): {exc}"
                ) from exc
        return out


def send_frame(sock: socket.socket, obj, *,
               max_bytes: int = MAX_FRAME_BYTES,
               timeout_s: float = 30.0) -> None:
    """Write one frame, handling nonblocking sockets: on a full send
    buffer, wait for writability (up to ``timeout_s``) and continue.
    Every failure mode — timeout, dead peer (EPIPE/ECONNRESET) mid-
    write — raises typed :class:`ProtocolError`: a partial frame has no
    resync point, so the connection is dead either way, and callers get
    ONE exception type for 'this peer is gone' instead of fishing raw
    ``OSError`` out of the middle of a write."""
    _send_bytes(sock, encode_frame(obj, max_bytes=max_bytes), timeout_s)


def send_kv_frame(sock: socket.socket, meta: dict, body: bytes, *,
                  max_bytes: int = MAX_FRAME_BYTES,
                  timeout_s: float = 30.0) -> None:
    """Write one binary KV frame (:func:`encode_kv_frame`) with the same
    nonblocking-socket discipline as :func:`send_frame`."""
    _send_bytes(
        sock, encode_kv_frame(meta, body, max_bytes=max_bytes), timeout_s
    )


def _send_bytes(sock: socket.socket, payload: bytes,
                timeout_s: float) -> None:
    data = memoryview(payload)
    while data:
        try:
            sent = sock.send(data)
        except (BlockingIOError, InterruptedError):
            sent = 0
        except OSError as exc:
            raise ProtocolError(
                f"send_frame: peer gone mid-write ({exc})"
            ) from exc
        if not sent:
            _, writable, _ = select.select([], [sock], [], timeout_s)
            if not writable:
                raise ProtocolError(
                    f"send_frame stalled > {timeout_s}s — peer not "
                    "draining its socket"
                )
            continue
        data = data[sent:]


def connect_with_retry(host: str, port: int, *,
                       deadline_s: float = 60.0,
                       backoff_base_s: float = 0.05,
                       backoff_max_s: float = 1.0,
                       clock=None, sleep=None) -> socket.socket:
    """Dial ``(host, port)`` with bounded retry + exponential backoff.

    Fleet bring-up races the router's dial against N workers' bind/
    listen: a worker that printed ``worker_ready`` has bound its port,
    but a slow-to-accept (or just-restarted) worker can still refuse the
    first SYN. Retrying here — instead of failing the whole ``--fleet``
    launch on one ECONNREFUSED — is what makes both cold bring-up and
    supervisor re-dial after a worker restart robust. Raises the last
    ``OSError`` once ``deadline_s`` is spent."""
    import time as _time

    clock = clock if clock is not None else _time.monotonic
    sleep = sleep if sleep is not None else _time.sleep
    deadline = clock() + deadline_s
    attempt = 0
    while True:
        budget = deadline - clock()
        try:
            return socket.create_connection(
                (host, int(port)), timeout=max(0.05, budget)
            )
        except OSError:
            pause = min(backoff_base_s * (2 ** attempt), backoff_max_s)
            if clock() + pause >= deadline:
                raise
            attempt += 1
            sleep(pause)


def recv_available(sock: socket.socket, decoder: FrameDecoder,
                   *, chunk: int = 65536) -> list | None:
    """Drain whatever is readable RIGHT NOW into ``decoder`` and return
    the completed frames; ``None`` means the peer closed the stream at a
    frame boundary (clean EOF). Never blocks: a would-block read returns
    the frames completed so far. EOF mid-frame is a
    :class:`ProtocolError` — the peer died between length word and
    payload."""
    frames: list = []
    while True:
        try:
            data = sock.recv(chunk)
        except (BlockingIOError, InterruptedError):
            return frames
        except socket.timeout:
            return frames
        except ConnectionResetError:
            # A peer that closed with unread data in its receive buffer
            # sends RST, not FIN — same meaning here: it is gone.
            data = b""
        if not data:
            if decoder.buffered:
                raise ProtocolError(
                    f"stream closed mid-frame with {decoder.buffered} "
                    "bytes buffered"
                )
            return frames if frames else None
        frames.extend(decoder.feed(data))
        if len(data) < chunk:
            return frames


def recv_frames_blocking(sock: socket.socket, decoder: FrameDecoder,
                         *, timeout_s: float = 30.0) -> list:
    """Block until AT LEAST one complete frame is available and return
    everything decoded so far (a peer may batch frames — e.g. a hello
    immediately followed by a first heartbeat). Raises
    ``ProtocolError`` on EOF or timeout."""
    deadline_left = timeout_s
    while True:
        frames = recv_available(sock, decoder)
        if frames is None:
            raise ProtocolError("stream closed before a complete frame")
        if frames:
            return frames
        readable, _, _ = select.select([sock], [], [], min(deadline_left,
                                                           0.25))
        if not readable:
            deadline_left -= 0.25
            if deadline_left <= 0:
                raise ProtocolError(
                    f"no frame within {timeout_s}s — peer silent"
                )


def digests_to_wire(digests: list[bytes]) -> list[str]:
    """Chain digests (16-byte blake2b) as hex strings for a JSON frame."""
    return [d.hex() for d in digests]


def digests_from_wire(hexes: list[str]) -> list[bytes]:
    try:
        return [bytes.fromhex(h) for h in hexes]
    except ValueError as exc:
        raise ProtocolError(f"malformed digest hex: {exc}") from exc
