"""Multi-device proving: the ("dp", "sp") mesh, the mesh-sharded opening
reduction and the mesh-sharded IOP rows engine.

Counterpart of jolt_atlas_tpu/parallel/. Lazy names, as there:
``opening.prove_batch_opening`` and ``RowsInstance.setup_rows`` probe
``active_mesh()`` on every prove.
"""


def __getattr__(name):
    if name in ("make_mesh", "sharded_product_round", "dryrun_proving_step",
                "Mesh"):
        from . import mesh
        return getattr(mesh, name)
    if name in ("mesh_scope", "active_mesh", "try_prove"):
        from . import shardedreduction
        return getattr(shardedreduction, name)
    raise AttributeError(name)


__all__ = ["make_mesh", "sharded_product_round", "dryrun_proving_step",
           "mesh_scope", "active_mesh"]
