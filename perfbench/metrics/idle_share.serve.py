"""idle_share.serve: the share of the traced serving sub-window in which
no operation ran on the device (%)."""


def read(record):
    if record.get("kind") != "serve":
        return None
    return max(100.0 * (1.0 - p["busy_s"] / p["window_s"]) for p in record["profile"])
