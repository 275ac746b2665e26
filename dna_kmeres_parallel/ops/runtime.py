"""Runtime backend capability: which device runs the program, and how the
one hand-written kernel (the Pallas-Triton (min,+) kernel,
ops/distance_pallas.py) runs there."""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Backend:
    """platform: 'gpu' or 'cpu' (JAX's name for the default device);
    device_kind: as JAX reports it; kernel: how the (min,+) kernel runs —
    'compiled' on a GPU, 'interpret' only when a test asks for it
    (KMER_PALLAS_INTERPRET=1), None where it cannot run."""

    platform: str
    device_kind: str
    kernel: str | None

    @property
    def accelerator(self) -> bool:
        """Whether the default device is an accelerator (not the host)."""
        return self.platform == "gpu"


@functools.lru_cache(maxsize=1)
def _device() -> tuple[str, str]:
    import jax

    dev = jax.devices()[0]
    return dev.platform, dev.device_kind


def backend() -> Backend:
    platform, kind = _device()
    if os.environ.get("KMER_PALLAS_INTERPRET") == "1":
        kernel = "interpret"
    elif platform == "gpu":
        kernel = "compiled"
    else:
        kernel = None
    return Backend(platform, kind, kernel)


#: host-allocation degrades taken this process, by route (see
#: host_alloc_failure); chip_smoke.py fails when any was taken.
DEGRADES: dict[str, int] = {}


def host_alloc_failure(e: BaseException, route: str) -> bool:
    """Whether an exception from a device route is a memory-allocation
    failure that the caller may answer by taking its low-memory route.
    Counts every such degrade in DEGRADES under ``route``. Anything else
    (a kernel that fails to compile included) is an error."""
    msg = str(e).lower()
    if isinstance(e, MemoryError) or "resource_exhausted" in msg or (
        "out of memory" in msg
    ):
        DEGRADES[route] = DEGRADES.get(route, 0) + 1
        return True
    return False
