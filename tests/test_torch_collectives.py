"""The dry run's collectives against the reference's partitioned HLO: train
cells.

Each smoke train cell is compiled by the reference on a (2, 2) and a
(1, 4) mesh of its four fake CPU devices, and its collectives read with
``launch/hlo_cost.py`` (trip-multiplied, operand bytes a device).  The
port runs the same cell once on a meta ``VirtualMesh`` of the same shape
(``launch/dryrun.py::run_cell``): its ``collectives["per_op"]`` (the
transfers it issues and those ``dist/implied.py`` implies) must hold the
same op kinds, each kind's bytes within 1 % of the reference's.  Counts
are printed beside the bytes and not held: XLA's combiner merges ops.
The serve cells are held the same way in ``tests/test_torch_serve.py``.

Every reference number comes from one dump that this file writes when it
runs as a script in a subprocess with four fake XLA devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/test_torch_collectives.py OUT.npz

The dump is started before the first port run and read after it, so the
reference's compiles overlap the port's meta runs.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

MESHES = ((2, 2), (1, 4))
# xlstm first: its meta runs are the longest, the dump compiles meanwhile
CELLS = [("xlstm-125m", "train_4k"), ("codeqwen1.5-7b", "train_4k"),
         ("granite-moe-1b-a400m", "train_4k"), ("whisper-base", "train_4k"),
         ("internvl2-76b", "train_4k")]
TOL = 0.01


def reference_collectives(cells, meshes):
    """The reference's smoke cells compiled on its devices: for each
    (arch, shape, mesh) and op kind, ``coll/...`` = (bytes, count)."""
    import jax
    from repro import configs
    from repro.dist import make_mesh
    from repro.launch import cells as rcells
    from repro.launch.hlo_cost import analyze

    full = rcells.configs.get_config
    rcells.configs.get_config = configs.get_smoke_config
    out = {}
    try:
        for arch, shape in cells:
            for ms in meshes:
                mesh = make_mesh(ms, ("data", "model"))
                cell = rcells.build_cell(arch, shape, mesh)
                with mesh:
                    text = jax.jit(
                        cell.fn, in_shardings=cell.in_shardings,
                        donate_argnums=cell.donate_argnums).lower(
                        *cell.args).compile().as_text()
                for kind, v in analyze(text).collectives.items():
                    out[f"coll/{arch}/{shape}/{ms[0]}x{ms[1]}/{kind}"] = \
                        np.asarray([v["bytes"], v["count"]])
    finally:
        rcells.configs.get_config = full
    return out


if __name__ == "__main__":
    np.savez(sys.argv[1], **reference_collectives(CELLS, MESHES))
    sys.exit(0)


import torch  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist.mesh import VirtualMesh  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

# six test workers share the host's cores with the reference's XLA
# subprocesses: a few torch threads a worker
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's dump, started in a subprocess and not waited for."""
    path = tmp_path_factory.mktemp("ref") / "coll4.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.Popen([sys.executable, __file__, str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield path, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def dump(reference_run):
    path, proc = reference_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    return dict(np.load(path))


def port_per_op(arch, shape, ms, monkeypatch):
    """The port's ``per_op`` of the smoke cell on a meta mesh ``ms``."""
    monkeypatch.setattr(tcells.configs, "get_config",
                        tconfigs.get_smoke_config)
    r = dryrun.run_cell(arch, shape, False,
                        mesh=VirtualMesh(ms, ("data", "model"), "meta"))
    return r["collectives"]["per_op"]


def assert_matches(got, dump, arch, shape, ms):
    """The port's kinds are the reference's, each within ``TOL``."""
    key = f"coll/{arch}/{shape}/{ms[0]}x{ms[1]}/"
    want = {k[len(key):]: v for k, v in dump.items() if k.startswith(key)}
    table = {k: (want.get(k, (0, 0)), (got[k]["bytes"], got[k]["count"])
                 if k in got else (0, 0)) for k in set(want) | set(got)}
    assert want and set(got) == set(want), table
    for kind, (nbytes, _) in want.items():
        assert abs(got[kind]["bytes"] - nbytes) <= TOL * nbytes, table


@pytest.mark.parametrize("ms", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_train_cell_collectives_match_reference_hlo(reference_run, request,
                                                    monkeypatch, arch, shape,
                                                    ms):
    got = port_per_op(arch, shape, ms, monkeypatch)
    assert_matches(got, request.getfixturevalue("dump"), arch, shape, ms)
    # a train cell over a model axis implies its gathers and reductions
    assert got["all-gather"]["source"] in ("implied", "issued+implied")
    assert got["all-reduce"]["bytes"] > 0
