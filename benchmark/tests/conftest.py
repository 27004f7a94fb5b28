"""The benchmark's CPU tests: run from the checkout's root with
``python -m pytest benchmark/tests``.  The program's disk caches go to a
temporary directory of the session."""

import pytest


@pytest.fixture(autouse=True, scope="session")
def _program_caches(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("caches")
    mp.setenv("SURFH_TABLE_CACHE", str(root / "tables"))
    mp.setenv("SURFH_CACHE_DIR", str(root / "wpsf"))
    yield
    mp.undo()
