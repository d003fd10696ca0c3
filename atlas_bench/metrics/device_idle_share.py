"""device_idle_share: the traced window's share in which no operation ran
on the device (1 - the union of device activity / the window), in %."""


def read(r):
    t = r["trace"]
    if not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
