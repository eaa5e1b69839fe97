"""Hold one cell's dry-run collectives against the reference's
partitioned HLO, outside the tier-1 tests.

The tier-1 tests hold the smoke cells of five families on (2, 2) and
(1, 4) meshes (``tests/test_torch_collectives.py``,
``tests/test_torch_serve.py``).  This holds any other cell once: a full
width one on the production mesh, or a smoke one whose meta run is too
long for tier-1 (``--smoke``):

    # the reference compiled on the mesh's fake CPU devices (needs JAX)
    PYTHONPATH=src python tools/collectives_one_cell.py reference OUT.json
    # the port's record of the same cell on a meta mesh (no JAX, no card)
    PYTHONPATH=src python tools/collectives_one_cell.py port OUT.json
    # the two side by side, each kind's bytes and counts
    python tools/collectives_one_cell.py compare REF.json PORT.json

``--arch`` and ``--shape`` pick the cell (codeqwen1.5-7b train_4k by
default), ``--mesh`` the mesh (16x16, the single pod) and ``--smoke`` the
smoke config.  Each writes the collectives a device (``hlo_cost``,
trip-multiplied, for the reference; ``per_op`` for the port) and its
seconds.
"""
import argparse
import json
import os
import sys
import time


def reference(arch, shape, mesh_shape, smoke):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{mesh_shape[0] * mesh_shape[1]}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from repro import configs
    from repro.dist import make_mesh
    from repro.launch import cells
    from repro.launch.hlo_cost import analyze

    if smoke:
        cells.configs.get_config = configs.get_smoke_config
    t0 = time.perf_counter()
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cell = cells.build_cell(arch, shape, mesh)
    with mesh:
        text = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       donate_argnums=cell.donate_argnums).lower(
            *cell.args).compile().as_text()
    coll = analyze(text).collectives
    return dict(collectives={k: dict(bytes=v["bytes"], count=v["count"])
                             for k, v in sorted(coll.items())},
                seconds=round(time.perf_counter() - t0, 3))


def port(arch, shape, mesh_shape, smoke):
    from repro_torch import configs
    from repro_torch.dist.mesh import VirtualMesh
    from repro_torch.launch import cells, dryrun

    if smoke:
        cells.configs.get_config = configs.get_smoke_config
    t0 = time.perf_counter()
    r = dryrun.run_cell(arch, shape, False, mesh=VirtualMesh(
        mesh_shape, ("data", "model"), "meta"))
    return dict(collectives=r["collectives"]["per_op"],
                seconds=round(time.perf_counter() - t0, 3))


def compare(ref, got):
    rows = []
    for k in sorted(set(ref["collectives"]) | set(got["collectives"])):
        r = ref["collectives"].get(k, dict(bytes=0, count=0))
        g = got["collectives"].get(k, dict(bytes=0, count=0))
        rel = (g["bytes"] - r["bytes"]) / r["bytes"] if r["bytes"] else None
        rows.append(dict(kind=k, reference_bytes=r["bytes"],
                         reference_count=r["count"], port_bytes=g["bytes"],
                         port_count=g["count"], port_over_reference=rel))
    return dict(rows=rows, reference_s=ref["seconds"],
                port_s=got["seconds"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("reference", "port", "compare"))
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
    if args.what == "compare":
        with open(args.paths[0]) as f, open(args.paths[1]) as g:
            out = compare(json.load(f), json.load(g))
        print(json.dumps(out, indent=1))
        return
    fn = reference if args.what == "reference" else port
    out = dict(arch=args.arch, shape=args.shape, mesh=args.mesh,
               smoke=args.smoke,
               **fn(args.arch, args.shape, mesh_shape, args.smoke))
    with open(args.paths[0], "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main()
