"""The port's render entry point vs the root ``render.py`` on the "pallas"
backend (16x16 tiles; K4's plain version on the port's side), with the
model directory and the checks of ``test_torch_render_entry.py``.
"""

from test_torch_render_entry import assert_render_entry_matches_jax
from test_torch_render_entry import model_dir  # noqa: F401  (fixture)


def test_render_entry_matches_jax_on_pallas(model_dir, tmp_path,  # noqa: F811
                                            monkeypatch):
    assert_render_entry_matches_jax(model_dir, "pallas", tmp_path,
                                    monkeypatch)
