"""Cross-implementation interop against the UNMODIFIED reference binary.

The golden `ref_cli_tx_*.f32` files were produced by the reference `ultra`
CLI built from /root/reference (cmake -DULTRA_BUILD_GUI=OFF, no source
changes), one file per product-surface frame type:

    ultra ptx ping            -s AA1AA -d BB2BB  -> ref_cli_tx_ping.f32
    ultra ptx connect         -s AA1AA -d BB2BB  -> ref_cli_tx_connect.f32
    ultra ptx disconnect      -s AA1AA -d BB2BB  -> ref_cli_tx_disconnect.f32
    ultra ptx "interop payload 123" -w ofdm      -> ref_cli_tx_ofdm.f32
    ultra ptx "dpsk interop"        -w dpsk      -> ref_cli_tx_dpsk_mapped.f32
      (the reference maps -w dpsk to MC-DPSK, main.cpp:94 — hence "mapped")

The reverse direction (reference `ultra prx` decoding OUR ptx audio) was
verified against the same binary: data frames over MC-DPSK and OFDM_COX
decode with the correct payload, and our PING is detected with corr=1.000
(see docs/PARITY.md "Bidirectional CLI interop").  These tests pin the
forward direction hermetically.
"""

import os

import numpy as np

from projectultra.modem.engine import ModemEngine
from projectultra.protocol import frame_v2 as F

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")


def _decode(name, waveform=None):
    audio = np.fromfile(os.path.join(GOLDEN, name), dtype=np.float32)
    modem = ModemEngine()
    if waveform is not None:
        modem.set_waveform_mode(waveform)
    frames, pings = [], []
    modem.on_frame = frames.append
    modem.on_ping = pings.append
    # EOF flush: reference TX files end at the last signal sample; a live
    # receiver keeps hearing past it (cli.run_prx does the same).
    modem.feed_audio(np.concatenate([audio, np.zeros(8000, np.float32)]))
    modem.poll()
    return frames, pings


def test_ref_ping_detected():
    frames, pings = _decode("ref_cli_tx_ping.f32")
    assert len(pings) == 1
    assert len(frames) == 0


def test_ref_connect_frame():
    frames, pings = _decode("ref_cli_tx_connect.f32")
    assert len(frames) == 1
    cf = F.ConnectFrame.deserialize(frames[0].frame_bytes)
    assert cf is not None
    assert cf.src_callsign == "AA1AA"
    assert cf.dst_callsign == "BB2BB"


def test_ref_disconnect_frame():
    frames, _ = _decode("ref_cli_tx_disconnect.f32")
    assert len(frames) == 1
    assert frames[0].header.type == F.FrameType.DISCONNECT


def test_ref_ofdm_cox_data():
    frames, _ = _decode("ref_cli_tx_ofdm.f32",
                        waveform=F.WaveformMode.OFDM_COX)
    assert len(frames) == 1
    df = F.DataFrame.deserialize(frames[0].frame_bytes)
    assert df is not None and df.payload_as_text() == "interop payload 123"


def test_ref_dpsk_flag_maps_to_mc_dpsk():
    frames, _ = _decode("ref_cli_tx_dpsk_mapped.f32")
    assert len(frames) == 1
    df = F.DataFrame.deserialize(frames[0].frame_bytes)
    assert df is not None and df.payload_as_text() == "dpsk interop"
    assert frames[0].waveform == F.WaveformMode.MC_DPSK
