"""Samples a channel encoded (MD5 included) in the window, over the
window's time, in millions a second."""


def read(rec):
    if rec["loop"] != "encode":
        return None
    return rec["samples"] / rec["window_s"] / 1e6
