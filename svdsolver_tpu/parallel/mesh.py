"""Device-mesh construction helpers."""

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices=None, dp=None, axis_names=("dp", "tp"), platform=None):
    """Build a 2-D ``(dp, tp)`` mesh over the first ``n_devices`` devices.

    ``dp`` defaults to the largest power-of-two divisor <= sqrt(n_devices)
    so both axes get devices; pass ``dp=1`` for pure tensor parallelism or
    ``dp=n_devices`` for pure data parallelism.  ``platform`` selects the
    backend (e.g. ``"cpu"`` for the virtual host mesh of the tests).  Too
    few devices of that platform is an error: a mesh is never quietly
    built from another platform's devices.  The mesh follows the
    algorithm's axes, not a physical topology.
    """
    devices = jax.devices(platform) if platform else jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"need {n_devices} {devices[0].platform} devices, have "
            f"{len(devices)} (a virtual CPU mesh needs platform='cpu' and "
            "--xla_force_host_platform_device_count)"
        )
    devices = devices[:n_devices]
    if dp is None:
        dp = 1
        while dp * 2 * dp * 2 <= n_devices and n_devices % (dp * 2) == 0:
            dp *= 2
    if n_devices % dp != 0:
        raise ValueError(f"dp={dp} must divide n_devices={n_devices}")
    tp = n_devices // dp
    mesh_devices = np.asarray(devices).reshape(dp, tp)
    return Mesh(mesh_devices, axis_names)
