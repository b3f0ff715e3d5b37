"""Frames a decode call sent to the host decoder (the final partial frame
and every frame the scan flagged), over the window's calls: the decode
`info`'s `host_frames`."""


def read(rec):
    if rec["loop"] != "decode" or not rec["units"]:
        return None
    return rec["host_frames"] / rec["units"]
