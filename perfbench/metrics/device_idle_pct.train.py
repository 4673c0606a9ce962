"""The share of the traced window in which no operation ran on the
device (one minus the union of the device operations' intervals over the
window), averaged over the cards a run uses."""


def read(rec):
    if not rec.get("busy_s") or not rec.get("traced_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["traced_s"])
