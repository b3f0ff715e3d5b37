"""FLAC decoders of the port. So far only `host_decoder`, the sequential
host decoder copied from flac_tpu, which checks CRC-8, CRC-16 and MD5."""
