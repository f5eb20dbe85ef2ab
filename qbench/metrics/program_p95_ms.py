"""The 95th percentile (linear between order statistics) of the latency of
every program in the window, in ms: from its submission to its result on the
host (host clock)."""

import numpy as np


def read(record):
    lat = record["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
