"""FLAC decoders of the port: `host_decoder`, the sequential host decoder
copied from flac_tpu (CRC-8, CRC-16 and MD5 checked); `frame_decoder`, the
batched frame decoder whose two sample loops are CUDA kernels on a GPU;
`stream`, the stream layer that indexes frames and decodes them in device
batches (`decode_bytes_device`, variable-blocksize streams included);
`seek`, positioned decoding (`SeekableDecoder`); and `streaming`, the
decode of a read callback in a bounded window (`ChunkedStreamDecoder`)."""
