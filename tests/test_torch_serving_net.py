"""The port's wire framing (``distributeddeeplearning_tpu_torch/serving/
net.py``): the JAX package's ``tests/test_serving_net.py`` cases run on the
port's copy — partial reads, oversized frames refused by name, malformed
payloads as typed ProtocolError, KV frames, the digest codec, dead-peer
writes and the bounded connect retry — and a seeded fuzz that encodes the
same objects and KV frames through both packages' modules and holds the
bytes equal, so a router of one package can talk to a worker of the other.
"""


import json
import random

import pytest

from distributeddeeplearning_tpu_torch.serving.net import (
    MAX_FRAME_BYTES,
    FrameDecoder,
    ProtocolError,
    digests_from_wire,
    digests_to_wire,
    encode_frame,
)


def test_round_trip_single_frame():
    obj = {"type": "heartbeat", "seq": 3, "gauges": {"pending": 2},
           "digests": ["ab" * 16], "t_s": 1.5, "none": None}
    (out,) = FrameDecoder().feed(encode_frame(obj))
    assert out == obj


def test_partial_reads_byte_by_byte():
    # A nonblocking recv loop can hand the decoder ANY split — including
    # one byte at a time, splitting the length word itself. Frames must
    # only surface once complete, then decode identically.
    objs = [{"op": "submit", "request": {"prompt": [1, 2, 3]}},
            {"type": "admitted", "request_id": 7},
            {"k": "x" * 300}]
    wire = b"".join(encode_frame(o) for o in objs)
    dec = FrameDecoder()
    got = []
    for i in range(len(wire)):
        frames = dec.feed(wire[i:i + 1])
        if i < len(wire) - 1 and dec.buffered:
            assert len(frames) <= 1
        got.extend(frames)
    assert got == objs
    assert dec.buffered == 0


def test_multiple_frames_in_one_chunk():
    objs = [{"i": i} for i in range(5)]
    wire = b"".join(encode_frame(o) for o in objs)
    assert FrameDecoder().feed(wire) == objs


def test_oversized_encode_rejected_by_name():
    with pytest.raises(ProtocolError, match="max_bytes"):
        encode_frame({"blob": "x" * 128}, max_bytes=64)
    # The default cap is generous but real.
    assert len(encode_frame({"ok": 1})) < MAX_FRAME_BYTES


def test_oversized_declared_length_rejected_before_buffering():
    # A corrupt (or hostile) length word must be rejected from the 4-byte
    # prefix alone — BEFORE any payload is buffered, so a bad peer cannot
    # OOM the decoder by declaring a huge frame.
    dec = FrameDecoder(max_bytes=1024)
    header = (2048).to_bytes(4, "big")
    with pytest.raises(ProtocolError, match="max_bytes"):
        dec.feed(header)
    assert dec.buffered <= 4  # nothing beyond the prefix was kept


def test_malformed_json_payload_is_protocol_error():
    payload = b"{not json!"
    wire = len(payload).to_bytes(4, "big") + payload
    with pytest.raises(ProtocolError, match="malformed JSON"):
        FrameDecoder().feed(wire)


def test_invalid_utf8_payload_is_protocol_error():
    payload = b"\xff\xfe\x00\x01"
    wire = len(payload).to_bytes(4, "big") + payload
    with pytest.raises(ProtocolError, match="malformed JSON"):
        FrameDecoder().feed(wire)


def test_round_trip_fuzz_random_sizes_and_splits():
    # Seeded fuzz: frames of wildly varying payload size, concatenated
    # and re-chunked at random boundaries, must decode back exactly and
    # in order. This is the shape a real TCP stream produces.
    rng = random.Random(0xF1EE7)
    objs = []
    for i in range(40):
        n = rng.choice([0, 1, 7, 63, 257, 1024, 5000])
        objs.append({
            "i": i,
            "payload": "".join(rng.choice("abcdef") for _ in range(n)),
            "nums": [rng.randrange(256) for _ in range(rng.randrange(9))],
        })
    wire = b"".join(encode_frame(o) for o in objs)
    dec = FrameDecoder()
    got, pos = [], 0
    while pos < len(wire):
        step = rng.randrange(1, 700)
        got.extend(dec.feed(wire[pos:pos + step]))
        pos += step
    assert got == objs
    assert dec.buffered == 0


# ---------------------------------------------------------------------------
# Binary KV frames: the prefill→decode handoff payload shares the stream
# with JSON frames and must survive the same arbitrary re-chunking
# ---------------------------------------------------------------------------


def _kv(meta, blocks):
    from distributeddeeplearning_tpu_torch.serving.net import encode_kv_frame

    body = b"".join(blocks)
    return encode_kv_frame({**meta, "sizes": [len(b) for b in blocks]}, body)


def test_kv_frame_round_trip():
    from distributeddeeplearning_tpu_torch.serving.net import KVFrame

    blocks = [b"\x01" * 33, b"", b"\xff\x00kv-ish\x00" * 5]
    meta = {"op": "kv_handoff", "request_id": 9, "part": 0, "last": True}
    (out,) = FrameDecoder().feed(_kv(meta, blocks))
    assert isinstance(out, KVFrame)
    assert out.meta["request_id"] == 9 and out.meta["last"] is True
    assert out.blocks() == blocks


def test_mixed_json_and_kv_frames_rechunked_fuzz():
    # A real handoff stream interleaves JSON control frames (submit,
    # heartbeat, kv_adopted acks) with binary KV parts. Concatenate a
    # seeded mix, replay it at random split boundaries, and require every
    # frame back in order with its kind intact — including KV bodies that
    # contain 0x00, fake length words, and KV_MAGIC itself.
    from distributeddeeplearning_tpu_torch.serving.net import KV_MAGIC, KVFrame

    rng = random.Random(0xD15A66)
    objs, wire = [], b""
    for i in range(30):
        if rng.random() < 0.5:
            o = {"i": i, "type": rng.choice(["heartbeat", "kv_adopted"]),
                 "pad": "j" * rng.randrange(200)}
            objs.append(o)
            wire += encode_frame(o)
        else:
            blocks = [bytes(rng.randrange(256) for _ in range(
                rng.choice([0, 1, 64, 300]))) for _ in range(rng.randrange(4))]
            blocks.append(KV_MAGIC + (1 << 30).to_bytes(4, "big"))
            objs.append(("kv", i, blocks))
            wire += _kv({"op": "kv_handoff", "i": i}, blocks)
    dec = FrameDecoder()
    got, pos = [], 0
    while pos < len(wire):
        step = rng.randrange(1, 500)
        got.extend(dec.feed(wire[pos:pos + step]))
        pos += step
    assert dec.buffered == 0
    assert len(got) == len(objs)
    for out, ref in zip(got, objs):
        if isinstance(ref, tuple):
            assert isinstance(out, KVFrame)
            assert out.meta["i"] == ref[1]
            assert out.blocks() == ref[2]
        else:
            assert out == ref


def test_kv_frame_oversized_rejected_by_name_on_encode():
    from distributeddeeplearning_tpu_torch.serving.net import encode_kv_frame

    with pytest.raises(ProtocolError, match="max_bytes"):
        encode_kv_frame({"sizes": [4096]}, b"\x00" * 4096, max_bytes=512)


def test_kv_frame_sizes_must_cover_body_on_encode():
    from distributeddeeplearning_tpu_torch.serving.net import encode_kv_frame

    # Encode enforces the same invariant decode checks — a torn handoff
    # can never be framed as valid.
    with pytest.raises(ProtocolError, match="do not cover body"):
        encode_kv_frame({"sizes": [8, 8]}, b"\x00" * 15)
    with pytest.raises(ProtocolError, match="do not cover body"):
        encode_kv_frame({"sizes": None}, b"")


def test_kv_frame_truncated_mid_block_is_protocol_error():
    import json as _json

    from distributeddeeplearning_tpu_torch.serving.net import KV_MAGIC

    # Hand-build a KV payload whose declared sizes overrun the actual
    # body — the shape a sender that died mid-chain would leave behind if
    # the length word still closed. Must be a typed error, not a short
    # slice silently adopted as a valid block.
    meta = _json.dumps({"sizes": [16, 16]}).encode()
    payload = KV_MAGIC + len(meta).to_bytes(4, "big") + meta + b"\x01" * 20
    wire = len(payload).to_bytes(4, "big") + payload
    with pytest.raises(ProtocolError, match="truncated mid-block"):
        FrameDecoder().feed(wire)


def test_kv_frame_malformed_meta_is_protocol_error():
    from distributeddeeplearning_tpu_torch.serving.net import KV_MAGIC

    # meta_len overrunning the payload, garbage meta JSON, and meta
    # without integer sizes each get their own typed rejection.
    bad_len = KV_MAGIC + (999).to_bytes(4, "big") + b"{}"
    wire = len(bad_len).to_bytes(4, "big") + bad_len
    with pytest.raises(ProtocolError, match="overruns"):
        FrameDecoder().feed(wire)

    bad_json = KV_MAGIC + (4).to_bytes(4, "big") + b"{nop"
    wire = len(bad_json).to_bytes(4, "big") + bad_json
    with pytest.raises(ProtocolError, match="malformed kv frame meta"):
        FrameDecoder().feed(wire)

    import json as _json
    meta = _json.dumps({"sizes": [4, "x"]}).encode()
    bad_sizes = KV_MAGIC + len(meta).to_bytes(4, "big") + meta + b"\x00" * 4
    wire = len(bad_sizes).to_bytes(4, "big") + bad_sizes
    with pytest.raises(ProtocolError, match="missing block sizes"):
        FrameDecoder().feed(wire)


def test_digest_hex_codec_round_trip():
    digests = [bytes(range(16)), b"\x00" * 16, b"\xff" * 16]
    assert digests_from_wire(digests_to_wire(digests)) == digests
    with pytest.raises(ProtocolError, match="digest hex"):
        digests_from_wire(["zz"])


# ---------------------------------------------------------------------------
# Socket hardening: dead-peer writes are typed; connect retry is bounded
# ---------------------------------------------------------------------------


def test_send_frame_to_dead_peer_is_protocol_error():
    import socket

    from distributeddeeplearning_tpu_torch.serving.net import send_frame

    a, b = socket.socketpair()
    a.setblocking(False)
    b.close()
    # One small frame may land in the kernel buffer before the EPIPE
    # surfaces; a mid-write failure MUST come back as ProtocolError, not
    # a raw OSError fished out of the middle of the send loop.
    with pytest.raises(ProtocolError, match="peer gone"):
        for _ in range(64):
            send_frame(a, {"op": "submit", "pad": "x" * 4096})
    a.close()


def test_connect_with_retry_backoff_schedule_and_success():
    import socket

    from distributeddeeplearning_tpu_torch.serving.net import connect_with_retry

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    host, port = srv.getsockname()
    # NOT listening yet: the first dials get ECONNREFUSED, like a
    # just-restarted worker that has printed ready but not accepted.
    t = [0.0]
    pauses = []

    def sleep(s):
        pauses.append(s)
        t[0] += s
        if len(pauses) == 3:
            srv.listen(1)  # comes up mid-retry

    sock = connect_with_retry(host, port, deadline_s=60.0,
                              backoff_base_s=0.05, backoff_max_s=0.4,
                              clock=lambda: t[0], sleep=sleep)
    sock.close()
    srv.close()
    # Exponential doubling from the base, capped.
    assert pauses == [pytest.approx(0.05), pytest.approx(0.1),
                      pytest.approx(0.2)]


def test_connect_with_retry_deadline_raises_last_oserror():
    import socket

    from distributeddeeplearning_tpu_torch.serving.net import connect_with_retry

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    host, port = srv.getsockname()  # bound, never listening
    t = [0.0]

    def sleep(s):
        t[0] += s

    with pytest.raises(OSError):
        connect_with_retry(host, port, deadline_s=1.0,
                           backoff_base_s=0.3, backoff_max_s=5.0,
                           clock=lambda: t[0], sleep=sleep)
    assert t[0] < 1.0  # gave up before sleeping past the deadline
    srv.close()


# ---------------------------------------------------------------------------
# Byte parity with the JAX package's net.py
# ---------------------------------------------------------------------------


def _random_obj(rng, depth=0):
    kind = rng.randrange(7 if depth < 3 else 5)
    if kind == 0:
        return rng.randrange(-2**40, 2**40)
    if kind == 1:
        return rng.random() * 10 ** rng.randrange(-6, 7)
    if kind == 2:
        return "".join(rng.choice("ab\u00e9\u2192\"\\\n ") for _ in
                       range(rng.randrange(12)))
    if kind == 3:
        return rng.choice([True, False, None])
    if kind == 4:
        return bytes(rng.randrange(256) for _ in range(16)).hex()
    if kind == 5:
        return [_random_obj(rng, depth + 1) for _ in range(rng.randrange(5))]
    return {f"k{rng.randrange(99)}": _random_obj(rng, depth + 1)
            for _ in range(rng.randrange(5))}


def test_frames_are_byte_equal_to_the_jax_package():
    from distributeddeeplearning_tpu.serving import net as jnet
    from distributeddeeplearning_tpu_torch.serving import net as tnet

    assert tnet.KV_MAGIC == jnet.KV_MAGIC
    assert tnet.MAX_FRAME_BYTES == jnet.MAX_FRAME_BYTES
    rng = random.Random(0x22F1EE7)
    wire_j, wire_t, objs = b"", b"", []
    for i in range(200):
        obj = {"type": rng.choice(["heartbeat", "result", "submit"]),
               "seq": i, "body": _random_obj(rng)}
        a, b = jnet.encode_frame(obj), tnet.encode_frame(obj)
        assert a == b, obj
        wire_j, wire_t = wire_j + a, wire_t + b
        objs.append(obj)
        blocks = [bytes(rng.randrange(256) for _ in range(
            rng.choice([0, 1, 64, 313]))) for _ in range(rng.randrange(4))]
        meta = {"op": rng.choice(["handoff", "adopt"]), "request_id": i,
                "epoch": rng.randrange(3), "offset": rng.randrange(9),
                "last": rng.random() < 0.5, "extra": _random_obj(rng),
                "digests": tnet.digests_to_wire(
                    [bytes(rng.randrange(256) for _ in range(16))
                     for _ in range(rng.randrange(4))]),
                "sizes": [len(x) for x in blocks]}
        body = b"".join(blocks)
        a = jnet.encode_kv_frame(meta, body)
        b = tnet.encode_kv_frame(meta, body)
        assert a == b, meta
        wire_j, wire_t = wire_j + a, wire_t + b
        objs.append((meta, blocks))
    assert wire_j == wire_t
    # Each package decodes the other's stream, re-chunked at random.
    for dec in (jnet.FrameDecoder(), tnet.FrameDecoder()):
        got, pos = [], 0
        while pos < len(wire_t):
            step = rng.randrange(1, 900)
            got.extend(dec.feed(wire_t[pos:pos + step]))
            pos += step
        assert len(got) == len(objs)
        for out, ref in zip(got, objs):
            if isinstance(ref, tuple):
                assert out.meta == ref[0] and out.blocks() == ref[1]
            else:
                assert out == ref
    hexes = ["00" * 16, "ff" * 16, bytes(range(16)).hex()]
    assert tnet.digests_from_wire(hexes) == jnet.digests_from_wire(hexes)
    assert tnet.digests_to_wire(tnet.digests_from_wire(hexes)) == hexes


@pytest.mark.parametrize("case", ["oversized", "overrun", "bad_meta",
                                  "bad_sizes", "truncated", "bad_json"])
def test_malformed_input_is_refused_as_jax_refuses_it(case):
    from distributeddeeplearning_tpu.serving import net as jnet
    from distributeddeeplearning_tpu_torch.serving import net as tnet

    meta = json.dumps({"sizes": [16, 16]}).encode()
    wire = {
        "oversized": (2048).to_bytes(4, "big"),
        "overrun": tnet.KV_MAGIC + (999).to_bytes(4, "big") + b"{}",
        "bad_meta": tnet.KV_MAGIC + (4).to_bytes(4, "big") + b"{nop",
        "bad_sizes": tnet.KV_MAGIC + (12).to_bytes(4, "big")
        + b'{"sizes":[1]',
        "truncated": tnet.KV_MAGIC + len(meta).to_bytes(4, "big") + meta
        + b"\x01" * 20,
        "bad_json": b"{not json!",
    }[case]
    if case != "oversized":
        wire = len(wire).to_bytes(4, "big") + wire
    msgs = []
    for mod in (jnet, tnet):
        with pytest.raises(Exception) as err:
            mod.FrameDecoder(max_bytes=1024).feed(wire)
        assert type(err.value).__name__ == "ProtocolError"
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
