"""Batched frame-level DSP of the encoder, in PyTorch (the port of
flac_tpu.dsp)."""
