"""The FLAC encoder in PyTorch: batched frame pipeline, field packer, stream
encoder (the port of flac_tpu.encode)."""
