#!/usr/bin/env python
"""CLI: distributed residual-flow + GMM color-normalizer training.

The entry-point role of ``dlmodels/color-information/train_img_horo.py``
(launched there via SLURM + mpirun, ``run.sh:20-63``). In JAX there is
no external launcher: run the same script on every host; ``--coordinator``
plus the process count bootstraps ``jax.distributed`` and the mesh spans all
devices (stainlib_tpu/parallel/mesh.py).

Example (single host):
  python scripts/train_flow.py --slides '/data/wsr/*.wsr' --steps 10000 \
      --image-size 64 --batch 64 --save /tmp/flow_ckpt

Multi-host (per host, rank r of N):
  python scripts/train_flow.py ... --coordinator host0:1234 \
      --num-processes N --process-id r
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--slides", help="glob of WSIRAW slides", default=None)
    p.add_argument("--xmls", help="glob of ASAP-XML annotations", default="")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--update-freq", type=int, default=1)
    p.add_argument("--n-scales", type=int, default=2)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--clusters", type=int, default=4)
    p.add_argument("--save", default="/tmp/stainlib_tpu_flow")
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--evaluate", action="store_true",
                   help="run validate() instead of training")
    p.add_argument("--vis-freq", type=int, default=0)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv or sys.argv[1:])

    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from stainlib_tpu.data.pipeline import DevicePrefetcher
    from stainlib_tpu.data.wsi import SamplerConfig, WsiSampler
    from stainlib_tpu.models.train_flow import (
        FlowConfig, init_flow_state, make_train_step,
    )
    from stainlib_tpu.models.validate_flow import validate
    from stainlib_tpu.ops.colorspace import rgb_to_hsd
    from stainlib_tpu.parallel.mesh import initialize_distributed, make_mesh
    from stainlib_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint
    from stainlib_tpu.utils.meters import RunningAverageMeter, get_logger

    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)
    log = get_logger("train_flow", rank=jax.process_index()).info
    mesh = make_mesh()

    cfg = FlowConfig(
        image_size=args.image_size, n_scales=args.n_scales,
        blocks_per_scale=args.blocks, hidden=args.hidden,
        n_clusters=args.clusters, lr=args.lr, warmup_iters=args.warmup,
        update_freq=args.update_freq,
    )

    if args.slides:
        sampler = WsiSampler(
            args.slides, args.xmls,
            SamplerConfig(tile=args.image_size, batch_size=args.batch),
            seed=args.seed,
        )
        host_batches = (t for t, _ in sampler.train_batches())
    else:  # synthetic smoke data so the script runs anywhere
        def synth():
            rng = np.random.default_rng(args.seed)
            he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
            he /= np.linalg.norm(he, axis=1, keepdims=True)
            while True:
                C = rng.random((args.batch, args.image_size,
                                args.image_size, 2)) * 1.5
                yield np.clip(255.0 * np.exp(-(C @ he)), 0, 255).astype(
                    np.uint8)

        host_batches = synth()

    batches = DevicePrefetcher(
        host_batches, depth=2,
        transform=lambda b: np.asarray(rgb_to_hsd(jnp.asarray(b))),
    )

    first = next(batches)
    flow, gmm, state, tx = init_flow_state(
        cfg, jax.random.PRNGKey(args.seed), sample_hsd=first
    )
    if args.resume:
        state = restore_checkpoint(args.save, state)
        log(f"resumed at step {int(state.step)}")

    if args.evaluate:
        res = validate(flow, gmm, cfg, state.params, state.spectral,
                       [first], [next(batches)],
                       jax.random.PRNGKey(args.seed + 1),
                       out_dir=args.save, log=log)
        log(f"NMI sd={res['nmi_sd']:.4f} cv={res['nmi_cv']:.4f}")
        return res

    step_fn = make_train_step(flow, gmm, cfg, tx, mesh=mesh)
    meter = RunningAverageMeter(0.97)
    state, loss = step_fn(state, first)
    for i in range(1, args.steps):
        state, loss = step_fn(state, next(batches))
        meter.update(float(loss))
        if i % 50 == 0:
            log(f"step {i}: bpd {meter.val:.4f} (avg {meter.avg:.4f})")
        if args.save_every and i % args.save_every == 0 and \
                jax.process_index() == 0:
            save_checkpoint(args.save, state, i)
    if jax.process_index() == 0:
        save_checkpoint(args.save, state, args.steps)
    log("done")
    return state


if __name__ == "__main__":
    main()
