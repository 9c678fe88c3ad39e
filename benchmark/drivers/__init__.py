"""Drivers, one per traffic kind: ``run(record, root, device, seconds, t_start, patch)``."""
