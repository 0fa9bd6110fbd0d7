"""The port's test files share one fixture: torch at two intra-op threads
for the module, restored after.  Import it into a test module
(`from torch_threads import _torch_threads  # noqa: F401`); being
autouse, it then applies to every test there."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for torch in this module, restored after: the
    suite's workers share the CPU, and torch's default pool (a thread per
    core in each) oversubscribes it several times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
