"""Test-run scheduling: one xdist work unit a case of ``tests/test_system.py``,
the longest handed out first.

Under ``--dist loadfile`` xdist sends every test of a file to one worker.
``tests/test_system.py`` holds a dozen cases that each run a multi-device
script in a subprocess for minutes, so its worker alone would set the
wall of the whole run while the others idle.  Here each of its cases is a
work unit of its own, and any free worker takes it; every other file
stays one unit, so a module-scoped fixture (a reference dump) still runs
once a file.

xdist queues the units largest first (``--loadscope-reorder``, its
default), which puts the one-test units of those scripts last: the
longest script then starts only once the big files are handed out, and
ends the run alone.  So the longest units go to the head of the queue,
longest first (``LONGEST_FIRST``, from ``--durations`` of a tier-1 run):
the scripts and the few files of several minutes, the six longest at
once, one a worker, and the next ones as each worker's second unit,
which xdist hands out at the start (a worker runs a test only once it
holds the next).  Without xdist the hook
is never called (``optionalhook``).
"""
import pytest

SPLIT_FILES = ("tests/test_system.py",)

# the longest work units first (seconds on one worker in loaded tier-1
# runs): tests/test_system.py's subprocess cases and the longest whole
# files, interleaved
_SCRIPT = "tests/test_system.py::test_multidevice_subprocess[{}]".format
LONGEST_FIRST = (
    _SCRIPT("mgg_sparse.py"),                      # 620-680
    _SCRIPT("collectives_property.py"),            # 495-570
    "tests/test_layer_plans.py",                   # 330-355
    _SCRIPT("mgg_equivalence.py"),                 # 190-270
    "tests/test_torch_collectives.py",             # 205-225
    "tests/test_models.py",                        # 185
    _SCRIPT("feature_store.py"),
    _SCRIPT("collectives.py"),
    _SCRIPT("serve_cluster.py"),
    "tests/test_system.py::test_dryrun_machinery_small_mesh",
    _SCRIPT("serve_gnn.py"),
    _SCRIPT("ring_tp.py"),
    _SCRIPT("gnn_training.py"),
    _SCRIPT("elastic_restore.py"),
    _SCRIPT("sampled_blocks.py"),
)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CaseScheduling(LoadFileScheduling):
        queue_ordered = False

        def _split_scope(self, nodeid):
            scope = super()._split_scope(nodeid)
            return nodeid if scope in SPLIT_FILES else scope

        def _assign_work_unit(self, node):
            # the first assignment follows the queue's construction
            if not self.queue_ordered:
                self.queue_ordered = True
                for scope in reversed(LONGEST_FIRST):
                    if scope in self.workqueue:
                        self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return CaseScheduling(config, log)
