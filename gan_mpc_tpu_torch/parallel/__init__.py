"""Data parallelism over ``torch.distributed`` (``gan_mpc_tpu/parallel``):
the mesh and its helpers (``mesh.py``), the rank launcher (``launch.py``),
the sharded steps (``sharded.py``) and ``dryrun_multichip`` (``dryrun.py``).
The steps' names load on first use, since the training modules import the
mesh's helpers."""

from gan_mpc_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    data_axes,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_batch,
)

_SHARDED = ("make_dp_tp_dynamics_step", "make_sharded_collect", "make_sharded_cost_step",
            "make_sharded_critic_step", "make_sharded_dynamics_step",
            "make_sharded_ensemble_step")


def __getattr__(name):
    if name in _SHARDED:
        from gan_mpc_tpu_torch.parallel import sharded

        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
