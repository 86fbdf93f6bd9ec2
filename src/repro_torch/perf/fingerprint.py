"""Hardware fingerprints for perf presets and trajectory rows.

A preset measured on one machine class must not steer policy selection on
another: ``resolve_fastest`` treats a preset whose fingerprint is STALE
exactly like no preset at all (it falls back to the pure accuracy
resolver).

The freshness test is coarse, as in the reference: the platform
(``platform``: ``cuda``/``cpu``) must match. Throughput ordering between
emulation policies is set by which MMA units exist, not by the exact CPU or
card SKU. On the card that is the compute capability, so a ``cuda`` preset
is fresh only where the recorded capability is the current card's: the
kernel routes a preset names (``+pallas``, ``+pallas+unfused``) are built
for ``sm_90a`` alone, and a winner measured on one generation says nothing
of another. A ``cuda`` preset that records no capability is never fresh.
Where no card is visible the current capability is unknown and the platform
alone decides (no call can run on the card there). The rest of the
fingerprint (card name, torch and CUDA versions, machine, system, core
count) is recorded for provenance, so a human reading a preset can judge
how far its numbers travel.

Unlike the reference, which keys freshness on JAX's process-wide default
backend, the port's entry points take explicit devices: one process may run
a CPU call and a card call side by side. So freshness is judged for the
device of the call (``hardware_fingerprint(device)``): a CPU call on a
machine with a card still finds the CPU preset fresh, and a card call is
never steered by it. With no device, the platform is the one the port's
entry points default to (the card when one is visible).

torch is imported lazily and its absence tolerated (platform
``"unknown"``), as the reference tolerates JAX's: the module itself needs
only the standard library.
"""
from __future__ import annotations

import os
import platform


def device_platform(device=None) -> str:
    """The platform of calls on ``device``: its device type (``"cuda"``,
    ``"cpu"``), or for None the device the port's entry points default to
    (the card when one is visible); ``"unknown"`` without torch."""
    if device is not None:
        return str(getattr(device, "type", device)).split(":", 1)[0]
    try:
        import torch
    except ImportError:
        return "unknown"
    return "cuda" if torch.cuda.is_available() else "cpu"


def hardware_fingerprint(device=None) -> dict:
    """Fingerprint of this machine for calls on ``device`` (a
    ``torch.device``, a string such as ``"cuda"`` / ``"cpu"``, or None for
    the port's default device)."""
    fp = {"platform": device_platform(device), "system": platform.system(),
          "machine": platform.machine(), "cpu_count": os.cpu_count(),
          "torch_version": None, "cuda_version": None, "device_name": None,
          "compute_capability": None}
    try:
        import torch
    except ImportError:
        fp["platform"] = "unknown"
        return fp
    fp["torch_version"] = torch.__version__
    fp["cuda_version"] = torch.version.cuda
    if fp["platform"] == "cuda" and torch.cuda.is_available():
        index = getattr(device, "index", None) or 0
        fp["device_name"] = torch.cuda.get_device_name(index)
        fp["compute_capability"] = list(torch.cuda.get_device_capability(index))
    return fp


def fingerprint_fresh(recorded: dict | None, current: dict | None = None) -> bool:
    """Whether a preset recorded under ``recorded`` may steer selection for
    calls fingerprinted ``current`` (None: the default device's).

    The platform must match, and on ``cuda`` the compute capability too
    wherever the current one is known (see module docstring); a missing or
    platform-less recorded fingerprint is never fresh: provenance is
    mandatory for a preset to be consulted.
    """
    if not recorded or "platform" not in recorded:
        return False
    cur = current if current is not None else hardware_fingerprint()
    if recorded["platform"] != cur.get("platform"):
        return False
    if recorded["platform"] != "cuda":
        return True
    have = recorded.get("compute_capability")
    want = cur.get("compute_capability")
    return have is not None and (want is None or list(have) == list(want))
