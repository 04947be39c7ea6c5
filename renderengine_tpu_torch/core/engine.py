"""Engine bootstrap.

The analog of the reference's process init (instance/device singletons,
``main.cpp:188-195``) plus its shader-cache persistence
(``Intermediate/Projects/shader_cache.json``,
``Scripts/compile-shaders.py:154-213``). Here the compiled artifacts are
the raster kernels' shared library (``raster/cuda_raster.py`` builds it
once per source into the package's ``build/`` directory and loads it);
``init()`` builds or loads it up front, so the first frame does not pay
for ``nvcc``. PyTorch runs eagerly, so there is no compiled-program cache
to point anywhere (the JAX package's XLA compile cache has no
counterpart), and the port keeps no other state between processes: each
renderer sizes its budgets with its estimators (the JAX package's
tuned-config record has no counterpart).
"""

from __future__ import annotations

import torch

from ..device import resolve_device

_initialized: set = set()


def init(device=None) -> torch.device:
    """Idempotent engine init for ``device`` (``cuda`` unless the caller
    passes one; raises without a card, as ``device.resolve_device``
    does): on a CUDA device, creates the CUDA context and builds or loads
    the raster kernels' library. Returns the device. Call before creating
    renderers (the apps do)."""
    dev = resolve_device(device)
    if str(dev) in _initialized:
        return dev
    if dev.type == "cuda":
        from ..raster import cuda_raster

        # a tiny allocation creates the context on the card
        torch.zeros(1, device=dev)
        cuda_raster._library()
        torch.cuda.synchronize(dev)
    _initialized.add(str(dev))
    return dev


def device_info(device=None) -> dict:
    """The PhysicalDevice-pick analog: report what we're running on."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "device_kind": dev.type,
                "n_devices": 1, "capability": None}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"platform": "gpu",
            "device_kind": torch.cuda.get_device_name(idx),
            "n_devices": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(idx))}
