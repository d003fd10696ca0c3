"""msm_device_ms: device milliseconds a proof of every operation launched
inside a call into the device MSM engine (device/msm.py DeviceBases.start
and finish, as the harness marks them)."""


def read(r):
    t = r["trace"]
    if not t["msm_calls"] or not t["msm_device_s"] or not r["proofs"]:
        return None
    return t["msm_device_s"] * 1e3 / r["proofs"]
