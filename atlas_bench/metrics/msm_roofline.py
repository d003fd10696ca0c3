"""msm_roofline: the least time the card could take for the MSMs handed to
the device engine (work.msm_bound_s of each one's points: textbook
Pippenger's IMADs or its bytes) over their device time, in %."""

from atlas_bench import work


def read(r):
    t, pk = r["trace"], r["peak"]
    if pk is None or not t["msm_device_s"] or not t["msm_points"]:
        return None
    bound = sum(work.msm_bound_s(n, pk) for n in t["msm_points"])
    return 100.0 * bound / t["msm_device_s"]
