"""What the process runs on: JAX's view of the devices and the card's limits."""

import subprocess

import jax


def describe():
    """``platform``, ``kind`` and ``count`` of the default devices."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def nvidia_smi():
    """Each card's name and power limit, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them.  Raises if the tool is missing or fails."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()
