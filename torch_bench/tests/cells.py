"""The cells the self-tests drive: every workload of the manifest."""

import harness

NAMES = [w["name"] for w in harness.load_manifest()["workloads"]]


def cell(name: str) -> "harness.Cell":
    return harness.resolve(name)
