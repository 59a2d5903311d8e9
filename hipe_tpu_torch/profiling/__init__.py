"""Stage timing, the performance report and the CSV corpus (torch port)."""
