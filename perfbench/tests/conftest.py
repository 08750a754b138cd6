import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    """Two CPU threads: the tiny cells' readings repeat, and workers do not thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A copy of the benchmark with the tiny cells of ``tiny.py`` added."""
    from perfbench.tests.tiny import make_root

    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="session")
def root_fp32(tmp_path_factory):
    from perfbench.tests.tiny import make_root

    return make_root(tmp_path_factory.mktemp("bench32"), precision="fp32")


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided inside the fixture)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
