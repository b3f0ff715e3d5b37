"""Seconds from the start of the process to the window's start: imports,
CUDA's start, the PCM made on the card and copied to the host, the
warm-up, and in a checkout's first run the kernels' builds."""


def read(rec):
    return rec["setup_s"]
