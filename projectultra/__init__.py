"""projectultra — batched HF software modem framework.

A ground-up JAX/XLA rebuild of the secup/ProjectUltra C++ modem: adaptive
HF waveforms (MC-DPSK, OFDM 512/1024-FFT, OTFS) with 648-bit LDPC coding,
dual-chirp / Schmidl-Cox synchronization, a v2 frame protocol with
selective-repeat ARQ — with every signal-path hot loop batched over frames
and SNR sweeps on an accelerator.
"""

__version__ = "0.1.0"
