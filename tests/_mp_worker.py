"""Subprocess worker for tests/test_multiprocess.py.

Each worker is one rank of a 2-process CPU deployment (the analogue of one
``mpirun`` rank in the reference's launch, ``run.sh:20-63``): it bootstraps
``jax.distributed`` through :func:`stainlib_tpu.parallel.mesh.
initialize_distributed`, takes its shard of a deterministic global dataset
via :func:`local_data_shard` (the ``hvd.rank()`` split of
``data_utils.py:1``), and runs ONE data-parallel residual-flow training step
over the global 2x2-device mesh — proving the multi-host path end to end
with real cross-process collectives (Gloo), not just the simulated
single-process mesh.

Usage: python tests/_mp_worker.py <process_id> <num_processes> <port>
"""

import sys


def main(pid: int, nproc: int, port: str) -> None:
    # Shared force-CPU-mesh recipe + synthetic tiles (safe pre-jax import:
    # __graft_entry__'s module top only imports numpy).
    from __graft_entry__ import _force_cpu_mesh, _make_tiles

    _force_cpu_mesh(2)

    import jax

    from stainlib_tpu.parallel.mesh import (
        initialize_distributed,
        local_data_shard,
        make_mesh,
    )

    initialize_distributed(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    n_dev = jax.device_count()
    assert n_dev == 2 * nproc, n_dev
    assert len(jax.local_devices()) == 2

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stainlib_tpu.models.train_flow import (
        FlowConfig,
        init_flow_state,
        make_train_step,
    )
    from stainlib_tpu.ops.colorspace import rgb_to_hsd

    mesh = make_mesh(data=n_dev)

    # Deterministic global dataset; this rank takes its contiguous shard.
    global_tiles = _make_tiles(4 * n_dev, 16, 16, seed=7)
    lo, hi = local_data_shard(len(global_tiles))
    assert hi - lo == len(global_tiles) // nproc
    local_hsd = np.asarray(rgb_to_hsd(jnp.asarray(global_tiles[lo:hi])))

    # Identical init on every rank (same seeds, same sample) — the
    # state-broadcast-from-rank-0 equivalent (train_img_horo.py:452-454).
    sample_hsd = np.asarray(rgb_to_hsd(jnp.asarray(global_tiles[:4])))
    cfg = FlowConfig(image_size=16, n_scales=1, blocks_per_scale=2, hidden=8,
                     n_power_series=2, n_clusters=3, warmup_iters=2)
    flow, gmm, state, tx = init_flow_state(
        cfg, jax.random.PRNGKey(0), sample_hsd=sample_hsd
    )
    step = make_train_step(flow, gmm, cfg, tx, mesh=mesh)

    # Globalize: batch sharded over 'data' across BOTH processes, state
    # replicated.
    sh_data = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    global_hsd = jax.make_array_from_process_local_data(
        sh_data, local_hsd, (len(global_tiles),) + local_hsd.shape[1:]
    )
    gstate = jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            rep, np.asarray(x), np.shape(x)
        ),
        state,
    )

    # De-flake: AOT-compile BEFORE the first collective, then hold every
    # rank at a coordination-service barrier (10-minute deadline) until all
    # executables are ready. Without this, a rank that compiles fast enters
    # the Gloo rendezvous and trips its internal ~30 s GetKeyValue deadline
    # while the peer is still compiling on a loaded host (the reference's
    # equivalent synchronization is the hvd.join() barrier,
    # train_img_horo.py:452-454).
    compiled = step.lower(gstate, global_hsd).compile()
    try:
        from jax._src import distributed as _dist

        _dist.global_state.client.wait_at_barrier(
            "stainlib_mp_post_compile", timeout_in_ms=600_000
        )
    except (ImportError, AttributeError):  # pragma: no cover - API drift
        pass  # fall back to the raw (flaky-under-load) behavior

    new_state, loss = compiled(gstate, global_hsd)
    jax.block_until_ready(loss)
    loss = float(loss)  # fully replicated -> addressable on every rank
    assert np.isfinite(loss), loss
    # Params moved and stayed replicated.
    p0 = new_state.params["gmm"]["mu"]
    assert p0.is_fully_replicated
    print(f"MP_OK {pid} loss {loss:.6f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
