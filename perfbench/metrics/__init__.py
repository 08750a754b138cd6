"""Per-layer metric readers, one file a metric (``<name>.py``: ``read(record)``), and their yardstick."""
