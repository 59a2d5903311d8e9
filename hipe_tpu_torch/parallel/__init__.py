"""Work partitioning, device discovery and ratio calibration (torch port)."""
