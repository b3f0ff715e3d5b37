"""Samples a channel that decode_bytes_device returned (MD5 checked) in
the window, over the window's time, in millions a second."""


def read(rec):
    if rec["loop"] != "decode":
        return None
    return rec["samples"] / rec["window_s"] / 1e6
