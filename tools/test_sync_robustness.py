#!/usr/bin/env python
"""OFDM Schmidl-Cox sync + decode robustness under front-end impairments.

Reference: tools/test_sync_robustness.cpp — PTT noise bursts, CFO up to
±50 Hz, static multipath echo, amplitude ramp (AGC settling), DC offset,
and the combined realistic case; 10 trials per condition, target 10/10.
Trials ride the batch axis per condition.

Usage: python tools/test_sync_robustness.py [--cpu] [--snr DB] [--trials N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--trials", type=int, default=10)
    args = ap.parse_args()
    import jax
    from projectultra.utils import backend
    backend.enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp
    from projectultra.config import ModemConfig, Modulation, CodeRate, bits_per_symbol
    from projectultra.fec import ldpc
    from projectultra.fec.interleave import channel_interleaver
    from projectultra.ofdm import carriers as C, modulator as M, pipeline as P
    from projectultra.ops import ldpc as ldpc_ops
    from projectultra.sim import watterson as W
    from projectultra.sync import schmidl_cox as SC

    B = args.trials
    snr = args.snr
    cfg = ModemConfig()
    mod = Modulation.QPSK
    rate = CodeRate.R1_4
    ncw = 2
    fs = 48000

    code = ldpc.get_code(rate)
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, (ncw, code.k)).astype(np.float32)
    cw = np.asarray(ldpc_ops.encode(code, jnp.asarray(info)))
    cm = C.carrier_map(cfg)
    ci = channel_interleaver(len(cm.data_idx) * bits_per_symbol(mod), code.n)
    inter = cw[:, ci.inv].reshape(1, -1)
    pre = M.generate_preamble(cfg)
    data = np.asarray(M.modulate(cfg, mod, jnp.asarray(inter),
                                 t_offset=M.preamble_data_t_offset(cfg)))[0]
    LEAD, TAIL = 7200, 4000
    tx = np.concatenate([np.zeros(LEAD, np.float32), pre, data,
                         np.zeros(TAIL, np.float32)])

    PTT = 12000  # 250 ms

    def impair(ptt_ms=0, cfo=0.0, mp_delay_ms=0.0, mp_gain=0.0,
               ramp_ms=0.0, dc=0.0, seed=0):
        x = np.broadcast_to(tx, (B, len(tx))).copy()
        if mp_gain > 0:
            d = int(mp_delay_ms * fs / 1000)
            x[:, d:] += mp_gain * x[:, :len(tx) - d]
        if ramp_ms > 0:
            r = int(ramp_ms * fs / 1000)
            x[:, :r] *= np.linspace(0.0, 1.0, r, dtype=np.float32)[None, :]
        y = jnp.asarray(x)
        if cfo:
            y = W.apply_cfo_hilbert(y, jnp.full((B,), cfo, jnp.float32))
        y = W.add_noise_active(jax.random.PRNGKey(100 + seed), y, snr)
        out = np.asarray(y)
        if ptt_ms:
            n = int(ptt_ms * fs / 1000)
            burst = 0.3 * np.random.default_rng(7 + seed).standard_normal(
                (B, n)).astype(np.float32)
            out = np.concatenate([burst, out], axis=-1)
        if dc:
            out = out + np.float32(dc)
        return jnp.asarray(out)

    conditions = [
        ("Clean", {}),
        ("PTT noise 250ms", dict(ptt_ms=250)),
        ("PTT noise 500ms", dict(ptt_ms=500)),
        ("CFO +25 Hz", dict(ptt_ms=250, cfo=25.0)),
        ("CFO -25 Hz", dict(ptt_ms=250, cfo=-25.0)),
        ("CFO +50 Hz", dict(ptt_ms=250, cfo=50.0)),
        ("CFO -50 Hz", dict(ptt_ms=250, cfo=-50.0)),
        ("Multipath 0.5ms g0.3", dict(ptt_ms=250, mp_delay_ms=0.5, mp_gain=0.3)),
        ("Multipath 1.0ms g0.3", dict(ptt_ms=250, mp_delay_ms=1.0, mp_gain=0.3)),
        ("Multipath 2.0ms g0.2", dict(ptt_ms=250, mp_delay_ms=2.0, mp_gain=0.2)),
        ("Amplitude ramp 50ms", dict(ptt_ms=250, ramp_ms=50.0)),
        ("Amplitude ramp 100ms", dict(ptt_ms=250, ramp_ms=100.0)),
        ("DC offset +0.05", dict(ptt_ms=250, dc=0.05)),
        ("DC offset -0.05", dict(ptt_ms=250, dc=-0.05)),
        ("Combined CFO+mp+ramp+DC", dict(ptt_ms=250, cfo=30.0, mp_delay_ms=1.0,
                                         mp_gain=0.25, ramp_ms=50.0, dc=0.02)),
    ]

    print(f"OFDM sync robustness — {mod.name} R1/4, SNR {snr:.0f} dB, "
          f"{B} trials/condition\n")
    passed = 0
    for i, (name, kw) in enumerate(conditions):
        rx = impair(seed=i, **kw)
        llrs, det = SC.decode_ofdm_cox(cfg, mod, rx, ncw)
        found = np.asarray(det["found"])
        blocks = np.asarray(llrs)[:, :ncw * code.n].reshape(B * ncw, code.n)
        deint = blocks[:, ci.perm]
        out, ok, _ = ldpc_ops.decode(code, jnp.asarray(deint))
        out = np.asarray(out).reshape(B, ncw, code.k)
        good = (np.asarray(ok).reshape(B, ncw).all(-1) & found
                & (out == info[None].astype(np.uint8)).all((-1, -2)))
        n_ok = int(good.sum())
        passed += n_ok == B
        print(f"  {name:<28} {n_ok:>2}/{B} {'PASS' if n_ok == B else 'FAIL'}")
    print(f"\n{passed}/{len(conditions)} categories at "
          f"{B}/{B} — {'ALL PASS' if passed == len(conditions) else 'FAILURES'}")
    return 0 if passed == len(conditions) else 1


if __name__ == "__main__":
    sys.exit(main())
