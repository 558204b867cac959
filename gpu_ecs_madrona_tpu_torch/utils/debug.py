"""In-step debug printing + runtime checks (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/utils/debug.py`` (reference HostPrint,
mw_gpu/host_print.hpp).  PyTorch runs eagerly, so both helpers are plain
host prints.  ``check`` reads the predicate back to the host, which waits
for the device: it is gated by GEM_TPU_DEBUG so release steps pay nothing.
"""

import os

import torch

DEBUG = bool(os.environ.get("GEM_TPU_DEBUG"))


def _host(x):
    return x.tolist() if isinstance(x, torch.Tensor) else x


def host_print(fmt: str, *args, **kwargs):
    """reference HostPrint::log — ``fmt`` uses str.format placeholders."""
    print(fmt.format(*map(_host, args),
                     **{k: _host(v) for k, v in kwargs.items()}), flush=True)


def check(pred, fmt: str, *args):
    """Debug-gated invariant check (prints on violation).  No-op unless
    GEM_TPU_DEBUG is set."""
    if not DEBUG:
        return
    if not bool(torch.as_tensor(pred).all()):
        host_print("CHECK FAILED: " + fmt, *args)
