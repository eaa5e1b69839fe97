"""Test-run scheduling: one xdist work unit a case of ``tests/test_system.py``.

Under ``--dist loadfile`` xdist sends every test of a file to one worker.
``tests/test_system.py`` holds a dozen cases that each run a multi-device
script in a subprocess for minutes, so its worker alone sets the wall of
the whole run while the others idle.  Here each of its cases is a work
unit of its own, and any free worker takes it; every other file stays one
unit, so a module-scoped fixture (a reference dump) still runs once a
file.  Without xdist the hook is never called (``optionalhook``).
"""
import pytest

SPLIT_FILES = ("tests/test_system.py",)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CaseScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            scope = super()._split_scope(nodeid)
            return nodeid if scope in SPLIT_FILES else scope

    return CaseScheduling(config, log)
