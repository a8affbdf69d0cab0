"""PyTorch's CPU ops on one thread for a test module of the port.

The tier-1 run puts six pytest workers on the machine's cores, and each
worker's PyTorch would start an OpenMP pool as wide as the machine: the
pools' spinning threads then starve each other and the CUDA emulation's
threads (srgan's int8 battery took 0.5 s alone and 90 s in the suite).
Four port tests run side by side took 115–190 s each with the default
pool and 9–48 s with one thread (``CHANGES.md``).  A module imports
the fixture to use it::

    from torch_port_threads import _one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module's tests; the old count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
