import pytest


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke cells are tiny: one intra-op thread runs them fastest and
    leaves the other test workers their cores."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
