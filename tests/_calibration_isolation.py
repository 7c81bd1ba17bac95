"""An autouse fixture for the port's tests: both packages' policy tables
read an empty calibration directory under the test's ``tmp_path``, so a
test that relies on the default operating point never reads
``artifacts/calibration``.  Import it into a test module:

    from _calibration_isolation import isolated_calibration  # noqa: F401
"""
import pytest


def _clear_caches() -> None:
    from repro.core.policy import clear_policy_table_cache as clear_jax
    from repro_torch.core.policy import clear_policy_table_cache as clear_port
    clear_jax()
    clear_port()


@pytest.fixture(autouse=True)
def isolated_calibration(tmp_path, monkeypatch):
    """``REPRO_CALIBRATION_DIR`` pinned to ``tmp_path / "calibration"`` (not
    created), both packages' table caches cleared before and after."""
    directory = tmp_path / "calibration"
    monkeypatch.setenv("REPRO_CALIBRATION_DIR", str(directory))
    _clear_caches()
    yield directory
    _clear_caches()
