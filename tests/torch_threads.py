"""One intra-op thread for the port's test modules that do much torch work
on the CPU. Under ``pytest -n 6`` every worker's torch would otherwise run
as many OpenMP threads as the machine has cores, and the workers' threads
spin against each other: a draw of 16 synthetic batches that takes 0.4 s
alone took more than 100 s beside five busy processes. A module imports
the fixture; the count is restored when the module ends."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
