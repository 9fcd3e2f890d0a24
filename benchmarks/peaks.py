"""Published peak rates of the devices the benchmarks may run on, keyed by
``jax.Device.device_kind``.  A device that is not in the table is an error:
a roofline share against a guessed peak would be a made-up number.

Source: NVIDIA H200 Tensor Core GPU data sheet (SXM part, dense rates, at
the full 700 W power limit).
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H200": {"hbm_bytes_per_s": 4.8e12, "bf16_flops_per_s": 989e12},
}


def device_peaks(dev) -> dict:
    """Peak table row for a jax Device; raises for an unknown device."""
    kind = getattr(dev, "device_kind", "")
    if kind not in PEAKS:
        raise RuntimeError(
            f"no published peaks for device_kind {kind!r} "
            f"(platform {dev.platform!r}); known: {sorted(PEAKS)}")
    return PEAKS[kind]


def require_gpu():
    """The first device, which must be a GPU: a measurement path that finds
    no accelerator fails rather than reporting a CPU number."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"benchmark needs a GPU, found {dev.platform!r}")
    return dev
