"""One intra-op thread for torch while a port test module runs on the CPU.
Not a test file; each of the port's CPU test modules imports
``one_torch_thread`` from it, which makes the fixture autouse there.

The port's CPU tests run tiny tensors, for which an intra-op parallel
region costs more than it computes.  Under pytest-xdist several workers
share the cores, and a region then waits for pool threads that the
scheduler has parked.  On an 8-core host, under ``pytest -n 6 --dist
loadfile``, ``test_torch_spec_drafter.py``'s long-context case took 188 s
on the default pool of one thread a core (12 s alone), and the whole
suite 1274 s; with this fixture the suite took 567 s.  The tests check
what they checked before; the process's own count is restored when the
module ends."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
