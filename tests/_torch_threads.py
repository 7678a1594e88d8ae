"""One PyTorch CPU thread for a test module (import ``one_torch_thread``).

The suite runs six test files at a time on a machine of a few cores. A
tiny model's PyTorch ops, split over every core, then wait on each other:
the port's 100-step ``Trainer`` test took 40 times its solo time. With one
thread a worker, each file stays near its solo time (and is no slower
alone: a tiny model's ops gain nothing from more threads)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)
