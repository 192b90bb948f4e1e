"""The device a measurement ran on, as recorded beside every number.

A time or a rate means nothing without the card it came from: a GPU may be
set below its maximum power and then runs slower under load.  ``describe``
gives JAX's view of the devices plus the power limit ``nvidia-smi``
reports; both go into every record ``bench.py`` writes.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional, Tuple

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def smi_id(device) -> str:
    """The id ``nvidia-smi -i`` takes for a JAX GPU device: its entry of
    ``CUDA_VISIBLE_DEVICES`` where that is set, else its CUDA ordinal.
    ``nvidia-smi`` counts cards in PCI bus order; CUDA does too under
    ``CUDA_DEVICE_ORDER=PCI_BUS_ID``, which the entry scripts set."""
    ordinal = device.local_hardware_id
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    if visible:
        return visible.split(",")[ordinal].strip()
    return str(ordinal)


def smi_line(device) -> Optional[str]:
    """The ``nvidia-smi`` name and power-limit line of one JAX GPU device,
    or None where there is no ``nvidia-smi``."""
    if shutil.which(SMI_QUERY[0]) is None:
        return None
    out = subprocess.run(SMI_QUERY + ["-i", smi_id(device)], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise RuntimeError(f"nvidia-smi gave {lines!r} for {device}")
    return lines[0]


def parse_smi_line(line: str) -> Tuple[str, str]:
    """Split one ``name, power.limit`` line: ``("NVIDIA H100 80GB HBM3",
    "700.00 W")``.  The name may itself hold no comma; the limit is the
    last field."""
    name, sep, limit = line.rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    return name.strip(), limit.strip()


def describe() -> Dict[str, object]:
    """platform, device_kind and count as JAX reports them, and the power
    limit of the first device's card (empty off the GPU or where
    ``nvidia-smi`` is absent)."""
    import jax

    devs = jax.devices()
    line = smi_line(devs[0]) if devs[0].platform == "gpu" else None
    limit = parse_smi_line(line)[1] if line else ""
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs), "power_limit": limit}
