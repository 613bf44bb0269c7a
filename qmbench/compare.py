"""The arithmetic of the comparisons that decide `correct`."""
import math


def worst(out, key, gap):
    """out[key] = the larger of out[key] and float(gap); a NaN or an
    infinity on either side wins, so a non-finite answer is never hidden
    by a maximum."""
    g = float(gap)
    cur = out[key]
    if not math.isfinite(cur):
        return
    if not math.isfinite(g) or g > cur:
        out[key] = g if not math.isnan(g) else math.inf
