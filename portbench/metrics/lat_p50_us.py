"""Median latency of every packet sent in the window, from its scheduled
send time to the return of the drain that hands back its row (us)."""

from portbench.bench import percentile


def read(rec):
    lat = rec.win.get("lat_s")
    if lat is None or not len(lat):
        return None
    return percentile(lat, 50) * 1e6
