"""The card's clocks and clock-limit reasons through NVML, loaded with ctypes.

NVML is the NVIDIA driver's management library (``libnvidia-ml.so.1``, the
one ``nvidia-smi`` reads through); no Python package binds it here. The
library loads, and NVML starts, at the first :func:`open_device`, never at
import. Its calls release the interpreter lock (``ctypes.CDLL``): a
sample's three take ~11 us on an H100's host at the median, but one in a
few thousand takes milliseconds, which a call that kept the lock would
take from every other thread. Three calls are read:

- ``nvmlDeviceGetClockInfo`` with ``NVML_CLOCK_SM`` and ``NVML_CLOCK_MEM``:
  the SM clock and the memory clock, in MHz;
- ``nvmlDeviceGetCurrentClocksEventReasons`` (named
  ``...ClocksThrottleReasons`` by drivers before it): a mask of
  :data:`REASONS`, why the clock is where it is.

:func:`open_device` finds the NVML device that is a torch CUDA device by its
UUID, never by its index: ``CUDA_VISIBLE_DEVICES`` renumbers torch's devices
and not NVML's. Where the library does not load
or a call fails, there is no device or no sample, and nothing raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LIBRARY = "libnvidia-ml.so.1"
CLOCK_SM, CLOCK_MEM = 1, 2  # nvmlClockType_t
# nvmlClocksEventReason* of nvml.h, by bit.
REASONS = {
    0x1: "gpu_idle",
    0x2: "applications_clocks_setting",
    0x4: "sw_power_cap",
    0x8: "hw_slowdown",
    0x10: "sync_boost",
    0x20: "sw_thermal_slowdown",
    0x40: "hw_thermal_slowdown",
    0x80: "hw_power_brake_slowdown",
    0x100: "display_clock_setting",
}
# The reasons that hold the clock below what the load asks for: the power
# cap, thermal and hardware slowdowns. Idle, application clocks, sync
# boost and display clocks say nothing of a limit.
LIMITING = 0x4 | 0x8 | 0x20 | 0x40 | 0x80


def reason_names(mask: int) -> list[str]:
    """The names of the reasons set in ``mask``, by bit; an unknown bit by
    its hexadecimal value."""
    return [REASONS.get(1 << b, hex(1 << b)) for b in range(mask.bit_length())
            if mask >> b & 1]


def _declare(fn, argtypes):
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


@functools.cache
def _library():
    """The library with NVML started, or ``None``."""
    try:
        lib = ctypes.CDLL(LIBRARY)
        if _declare(lib.nvmlInit_v2, [])() != 0:
            return None
    except (OSError, AttributeError):
        return None
    return lib


class Device:
    """One NVML device: :meth:`sample` reads its clocks and reasons."""

    def __init__(self, lib, handle: ctypes.c_void_p):
        self._handle = handle
        self._clock = _declare(lib.nvmlDeviceGetClockInfo,
                               [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint)])
        try:
            reasons = lib.nvmlDeviceGetCurrentClocksEventReasons
        except AttributeError:
            reasons = lib.nvmlDeviceGetCurrentClocksThrottleReasons
        self._reasons = _declare(reasons, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)])
        self._sm = ctypes.pointer(ctypes.c_uint())
        self._mem = ctypes.pointer(ctypes.c_uint())
        self._mask = ctypes.pointer(ctypes.c_ulonglong())

    def sample(self):
        """``(SM MHz, memory MHz, reasons mask)``, or ``None`` where a call
        failed."""
        if (self._clock(self._handle, CLOCK_SM, self._sm)
                or self._clock(self._handle, CLOCK_MEM, self._mem)
                or self._reasons(self._handle, self._mask)):
            return None
        return self._sm.contents.value, self._mem.contents.value, self._mask.contents.value


def open_device(index):
    """The NVML device of torch's CUDA device ``index``, or ``None`` where
    ``index`` is ``None``, the library does not load or NVML does not find
    the device's UUID."""
    if index is None:
        return None
    lib = _library()
    if lib is None:
        return None
    try:
        uuid = torch.cuda.get_device_properties(index).uuid
    except (RuntimeError, AssertionError):  # torch without that device
        return None
    handle = ctypes.c_void_p()
    find = _declare(lib.nvmlDeviceGetHandleByUUID,
                    [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)])
    if find(f"GPU-{uuid}".encode(), ctypes.byref(handle)) != 0:
        return None
    try:
        return Device(lib, handle)
    except AttributeError:  # a driver without the reasons' call
        return None
