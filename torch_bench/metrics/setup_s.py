"""Seconds from the process's start to the window's first step: import,
build or load of the kernels, the data, the warm-up."""


def read(r: dict):
    return r["setup_s"]
