"""``python -m neuralgaussiansplatting_torch.trainn`` from the saved PLY
of the port's train entry point (``--start_ply``), for ``--sw`` 2 and 3,
with the model and the checks of ``test_torch_neural_cli.py``.
"""

import pytest

from test_torch_neural_cli import classic  # noqa: F401  (fixture)
from test_torch_neural_cli import run_trainn_cli


@pytest.mark.parametrize("sw", [2, 3])
def test_trainn_cli_from_ply(classic, sw, tmp_path):  # noqa: F811
    run_trainn_cli(classic, sw, "ply", tmp_path)
