"""frame_v2 byte-exactness vs golden vectors from the C++ reference.

Reference: src/protocol/frame_v2.{hpp,cpp}; mirrors tests/test_frame_v2.cpp.
"""

import os

import numpy as np
import pytest

from projectultra.config import CodeRate, Modulation
from projectultra.protocol import frame_v2 as F


@pytest.fixture(scope="module")
def golden(golden_dir):
    out = {}
    cws, encs = [], {}
    for line in open(os.path.join(golden_dir, "golden_frames.txt")):
        k, v = line.split()
        if k == "cw":
            cws.append(v)
        else:
            out[k] = v
    out["cws"] = cws
    return out


def test_hash_and_crc(golden):
    assert F.hash_callsign("W1AW") == int(golden["hash_W1AW"], 16)
    assert F.hash_callsign("ve3abc") == int(golden["hash_VE3ABC"], 16)
    assert F.crc16_ccitt(bytes([1, 2, 3, 4, 5])) == int(golden["crc16"], 16)


def test_control_frames(golden):
    assert F.ControlFrame.make_ack("W1AW", "VE3ABC", 42).serialize().hex() == golden["ack"]
    assert F.ControlFrame.make_nack("W1AW", "VE3ABC", 7, 0x1D).serialize().hex() == golden["nack"]
    mc = F.ControlFrame.make_mode_change("W1AW", "VE3ABC", 3, Modulation.QAM16,
                                         CodeRate.R2_3, 21.3, 0)
    assert mc.serialize().hex() == golden["modechange"]

    rt = F.ControlFrame.deserialize(bytes.fromhex(golden["nack"]))
    assert rt is not None and rt.type == F.FrameType.NACK and rt.seq == 7
    np_ = F.NackPayload.decode(rt.payload)
    assert np_.cw_bitmap == 0x1D and np_.count_failed() == 4


def test_data_frame(golden):
    payload = bytes(i * 3 & 0xFF for i in range(50))
    df = F.DataFrame.make_data("W1AW", "VE3ABC", 9, payload)
    assert df.serialize().hex() == golden["dataframe"]
    assert df.total_cw == int(golden["data_total_cw"])
    dfr = F.DataFrame.make_data("W1AW", "VE3ABC", 9, payload, CodeRate.R1_2)
    assert dfr.total_cw == int(golden["data_total_cw_r12"])

    rt = F.DataFrame.deserialize(df.serialize())
    assert rt is not None and rt.payload == payload and rt.seq == 9


def test_connect_frames(golden):
    cf = F.ConnectFrame.make_connect("W1AW", "VE3ABC", 0x3F, 0xFF)
    assert cf.serialize().hex() == golden["connect"]
    ca = F.ConnectFrame.make_connect_ack("VE3ABC", "W1AW", 0x05,
                                         Modulation.DQPSK, CodeRate.R1_2, 12.7)
    assert ca.serialize().hex() == golden["connectack"]

    rt = F.ConnectFrame.deserialize(ca.serialize())
    assert rt is not None
    assert rt.src_callsign == "VE3ABC" and rt.dst_callsign == "W1AW"
    assert rt.negotiated_mode == 0x05
    assert abs(F.decode_snr(rt.measured_snr) - 12.7) < 0.25


def test_split_and_reassemble(golden):
    payload = bytes(i * 3 & 0xFF for i in range(50))
    ser = F.DataFrame.make_data("W1AW", "VE3ABC", 9, payload).serialize()
    cws = F.split_into_codewords(ser)
    assert len(cws) == int(golden["ncw"])
    for mine, ref in zip(cws, golden["cws"]):
        assert mine.hex() == ref
    re = F.reassemble_codewords(cws, len(ser))
    assert re == ser

    info = F.parse_header(cws[0])
    assert info.valid and not info.is_control
    assert info.total_cw == int(golden["data_total_cw"])
    t, idx = F.identify_codeword(cws[1])
    assert t == F.CodewordType.DATA and idx == 1


def test_ldpc_encode_matches(golden):
    payload = bytes(i * 3 & 0xFF for i in range(50))
    ser = F.DataFrame.make_data("W1AW", "VE3ABC", 9, payload).serialize()
    enc = F.encode_frame_with_ldpc(ser)
    assert len(enc) == int(golden["nenc"])
    assert enc[0].hex() == golden["enc0"]
    assert enc[-1].hex() == golden["enclast"]
    enc2 = F.encode_frame_with_ldpc(ser, CodeRate.R1_2)
    assert len(enc2) == int(golden["nenc_r12"])
    assert enc2[0].hex() == golden["enc2_0"]


def test_ldpc_decode_roundtrip():
    payload = b"Hello HF world! This message spans multiple codewords." * 2
    ser = F.DataFrame.make_data("W1AW", "VE3ABC", 1, payload).serialize()
    enc = F.encode_frame_with_ldpc(ser)
    # bits -> hard LLRs
    from projectultra.utils.bits import bytes_to_bits
    soft = [np.where(bytes_to_bits(cw)[:648] > 0, -6.0, 6.0).astype(np.float32)
            for cw in enc]
    decoded, data = F.decode_codewords_with_ldpc(soft)
    assert all(decoded)
    info = F.parse_header(data[0])
    assert info.valid
    expected = F.HEADER_SIZE + info.payload_len + F.CRC_SIZE
    frame = F.reassemble_codewords(data, expected)
    rt = F.DataFrame.deserialize(frame)
    assert rt is not None and rt.payload == payload


def test_ping():
    assert F.ping_serialize() == b"ULTR"
    assert F.is_ping(b"ULTRxx") and not F.is_ping(b"XYZ")


def test_parsers_never_raise_on_garbage():
    """Fuzz gate: every deserializer must reject (return None/invalid), not
    raise, on arbitrary bytes — RX feeds LDPC output straight into these
    (frame_v2.cpp parsers have the same total-function contract)."""
    import numpy as np
    rng = np.random.default_rng(7)
    for _ in range(500):
        n = int(rng.integers(0, 200))
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for payload in (data, b"\x55\x4c" + data):
            hdr = F.parse_header(
                payload.ljust(F.BYTES_PER_CODEWORD, b"\0")[:F.BYTES_PER_CODEWORD])
            # Random bytes must be REJECTED (CRC16 gates), not just not
            # raise: a valid result from garbage would flow into RX.
            assert not hdr.valid
            assert F.ControlFrame.deserialize(payload) is None
            assert F.DataFrame.deserialize(payload) is None
            assert F.ConnectFrame.deserialize(payload) is None
