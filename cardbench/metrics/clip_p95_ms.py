"""The 95th percentile of the wall time a file, from StreamEncoder(...)
through finish(), over every file finished in the window (numpy's linear
interpolation between ranks)."""

import numpy as np


def read(rec):
    walls = rec.get("file_walls_ms")
    if not walls:
        return None
    return float(np.percentile(np.asarray(walls), 95))
