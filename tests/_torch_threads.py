"""One torch intra-op thread for the parity tests of a module.

The port's CPU parity runs are many small torch ops (a linear per sLSTM
position, the plain LUT paths). Where several test processes share the
cores, torch's intra-op thread pool makes each such op wait for threads
that other processes hold, and a test that takes seconds alone takes
minutes. One thread gives the same results here (every test passes with
``OMP_NUM_THREADS=1``) at a fraction of the time.

Import the fixture into a test module to use it:
``from _torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
