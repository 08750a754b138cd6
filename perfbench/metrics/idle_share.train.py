"""idle_share.train: the share of the traced training sub-window in which
no operation ran on the device, on the rank with the most idle (%)."""


def read(record):
    if record.get("kind") != "train":
        return None
    return max(100.0 * (1.0 - p["busy_s"] / p["window_s"]) for p in record["profile"])
