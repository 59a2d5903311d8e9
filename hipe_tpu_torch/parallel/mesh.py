"""Device discovery — the part of ``hipe_tpu.parallel.mesh`` the engine uses.

The reference enumerates OpenCL platforms/devices, taking the first CPU and
first GPU found (`heterogeneous_blur.c:142-191`) and hard-failing if a
requested device is missing (`:181-184`). Here the "platforms" are
PyTorch's: the host CPU (``torch.device("cpu")``), which plays the
reference's CPU-OpenCL-device role, and each visible CUDA card
(``cuda:0``, ``cuda:1``, ...). ``hipe_tpu``'s meshes and shardings
(``make_mesh*``, ``batch_sharding``, ``row_sharding``) are not carried yet
(ROADMAP.md, item 9).
"""

from __future__ import annotations

import dataclasses
import platform

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInventory:
    """Discovered devices, mirroring the reference's discovery banner."""

    cpu_devices: list
    accel_devices: list
    accel_platform: str | None

    def describe(self) -> str:
        lines = []
        for i, plat in enumerate(self._platforms()):
            lines.append(f"Platform {i}: {plat}")
        if self.cpu_devices:
            lines.append(f"CPU device: {platform.processor() or platform.machine()}")
        if self.accel_devices:
            dev = self.accel_devices[0]
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
            lines.append(f"Accelerator device: {name} x{len(self.accel_devices)}")
        return "\n".join(lines)

    def _platforms(self) -> list[str]:
        plats = []
        if self.cpu_devices:
            plats.append("torch-cpu (host)")
        if self.accel_platform:
            plats.append(f"torch-{self.accel_platform}")
        return plats


def discover() -> DeviceInventory:
    """Enumerate the host CPU and the visible CUDA cards (analog of
    clGetPlatformIDs/DeviceIDs)."""
    accel, plat = [], None
    if torch.cuda.is_available():
        accel = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        plat = "cuda"
    return DeviceInventory(cpu_devices=[torch.device("cpu")], accel_devices=accel,
                           accel_platform=plat)


def require_device(inv: DeviceInventory, kind: str) -> torch.device:
    """Return the first device of `kind` ('cpu'|'accel'); hard-fail if absent

    (mirrors heterogeneous_blur.c:181-184)."""
    devs = inv.cpu_devices if kind == "cpu" else inv.accel_devices
    if not devs:
        raise RuntimeError(f"Error: no {kind} device found")
    return devs[0]
