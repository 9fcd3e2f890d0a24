"""Device mesh construction.

The multi-device scheduling analog (reference round-robin device pick,
opencl_serv.c:100-106) — except here the mesh is declarative: shardings
place data, XLA inserts the collectives.  Axis naming conventions:

  dp              — flat data/shuffle parallelism across all devices; the
                    layout for the cards of one machine, which all reach
                    each other at the same rate
  hosts x chips   — 2D mesh for a cluster of several nodes: the shuffle
                    exchange runs in two stages, all_to_all over "chips"
                    within a node, then over "hosts", so only the rows
                    bound for another node cross the inter-node network.

`pg_strom.dist_mesh_hosts` > 1 selects the 2D shape; the virtual-device
test rig exercises it as (2, 4) over 8 CPU devices."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def _devices(n: int | None):
    devs = jax.devices()
    if n is not None:
        if len(devs) < n:
            raise RuntimeError(
                f"need {n} devices, have {len(devs)} "
                f"(set XLA_FLAGS=--xla_force_host_platform_device_count=N "
                f"with JAX platform cpu for virtual-device testing)")
        devs = devs[:n]
    return devs


def get_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """Flat 1D mesh over all (or the first n) devices."""
    return Mesh(np.array(_devices(n_devices)), (axis,))


def get_mesh2(n_hosts: int, n_chips: int | None = None) -> Mesh:
    """2D ("hosts", "chips") mesh: n_hosts rows of n_chips devices each.

    Devices are enumerated host-major (jax.devices() orders by
    process/host), so row h of the mesh holds node h's devices: "chips"
    axis collectives stay within a node and "hosts" crosses nodes."""
    devs = _devices(None)
    if n_chips is None:
        if len(devs) % n_hosts:
            raise RuntimeError(
                f"{len(devs)} devices not divisible by {n_hosts} hosts")
        n_chips = len(devs) // n_hosts
    need = n_hosts * n_chips
    if len(devs) < need:
        raise RuntimeError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(n_hosts, n_chips),
                ("hosts", "chips"))


def mesh_for_config(n_devices: int | None = None) -> Mesh:
    """Mesh per the GUCs: dist_mesh_hosts > 1 -> 2D, else flat.

    A hosts setting the device count can't honor (fewer devices than
    hosts, or not divisible) degrades to the flat mesh instead of
    crashing the query — the GUC is a layout HINT, and `SET
    pg_strom.dist_mesh_hosts = 2` on a single-chip runtime must behave
    like the reference's GUCs do on absent hardware (round-5 fuzzer
    find: reshape(2, 0) ValueError)."""
    from ..config import config
    h = int(getattr(config, "dist_mesh_hosts", 1) or 1)
    if h > 1:
        devs = _devices(n_devices)
        if len(devs) >= h and len(devs) % h == 0:
            return Mesh(np.array(devs).reshape(h, len(devs) // h),
                        ("hosts", "chips"))
    return get_mesh(n_devices)
