#!/usr/bin/env python
"""Capacity-flow DEPLOYMENT throughput: the full recolor step on the chip.

Measures dependent-chain imgs/sec (bench.chain_tps)
of the deployed recolor step

    uint8 RGB -> HSD -> encode (flow + GMM gamma) -> per-class transfer
    -> uint8 RGB

at the reference's published capacity, for each shipped transfer family.
This is the reference's throughput-measured eval path — its deploy loop
prints imgs/sec per batch (``train_img_horo.py:728,862``); this is the
framework's equivalent number. Per-batch SOURCE
statistics are recomputed inside the step exactly as
``validate_flow.deploy`` does (the reference's one-(mu,sigma)-per-batch
contract, ``train_img_horo.py:703-705``) — so 'quantile'/'rgb-quantile'
pay their per-batch quantile extraction in the measured number.

    python scripts/bench_flow_deploy.py --ckpt /tmp/flow_mc3k/ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default="/tmp/flow_mc3k/ckpt",
                   help="train_flow_capacity.py checkpoint directory")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--transfers", default="diag,full,quantile,rgb-quantile")
    p.add_argument("--raw-weights", action="store_true",
                   help="bench the raw (non-EMA) parameters")
    p.add_argument("--out", default="/tmp/bench_flow_deploy.json")
    return p.parse_args(argv)


def run(args):
    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from bench import chain_tps

    from stainlib_tpu.data.synthetic import center_tiles
    from stainlib_tpu.models import color_eval
    from stainlib_tpu.models.train_flow import (
        encode, init_flow_state, reference_capacity)
    from stainlib_tpu.models.validate_flow import accumulate_template_stats
    from stainlib_tpu.ops.colorspace import hsd_to_rgb, rgb_to_hsd
    from stainlib_tpu.utils.checkpoint import restore_checkpoint

    import dataclasses

    cfg = dataclasses.replace(reference_capacity(), image_size=args.size)
    to_hsd = jax.jit(rgb_to_hsd)

    tmpl = center_tiles(0, max(args.batch * 4, 32), args.size, args.size,
                        seed=100)
    tmpl_hsd = np.asarray(to_hsd(jnp.asarray(tmpl)))
    flow, gmm, state, _ = init_flow_state(
        cfg, jax.random.PRNGKey(0), sample_hsd=tmpl_hsd[:args.batch])
    state = restore_checkpoint(args.ckpt, state)
    params = state.params if args.raw_weights else state.ema.params
    spectral = state.spectral
    print(f"checkpoint step {int(state.step)}, "
          f"{'raw' if args.raw_weights else 'EMA'} weights", flush=True)

    key = jax.random.PRNGKey(1)
    results = {}
    for transfer in [t.strip() for t in args.transfers.split(",") if t.strip()]:
        full = transfer == "full"
        quant = transfer in ("quantile", "rgb-quantile")
        composite = transfer in ("full-quantile", "rgb-full-quantile")
        q_space = "rgb" if transfer.startswith("rgb-") else "hsd"
        stats = accumulate_template_stats(
            flow, gmm, cfg, params, spectral,
            [tmpl_hsd[i:i + args.batch]
             for i in range(0, len(tmpl_hsd), args.batch)],
            key, return_cov=full or composite,
            return_quantiles=quant or composite,
            quantile_space=q_space,
            moment_space=q_space if composite else "hsd")

        def step(batch_u8, i, stats=stats, full=full, quant=quant,
                 composite=composite, q_space=q_space):
            """One deploy batch, uint8 -> uint8 (chainable)."""
            k = jax.random.fold_in(key, i)
            hsd = rgb_to_hsd(batch_u8)
            _, _, gamma = encode(flow, gmm, params, spectral, cfg, hsd, k)
            if composite:
                xq = hsd if q_space == "hsd" else hsd_to_rgb(hsd)
                mu_s, cov_s = color_eval.class_color_cov(xq, gamma)
                return color_eval.image_dist_transform_full_quantile(
                    xq, gamma, mu_s, cov_s, stats.mu, stats.cov,
                    stats.quantiles, space=q_space)
            if quant:
                xq = hsd if q_space == "hsd" else hsd_to_rgb(hsd)
                q_s, _ = color_eval.class_channel_quantiles(xq, gamma)
                return color_eval.image_dist_transform_quantile(
                    xq, gamma, q_s, stats.quantiles, space=q_space)
            if full:
                mu_s, cov_s = color_eval.class_color_cov(hsd, gamma)
                return color_eval.image_dist_transform_full(
                    hsd, gamma, mu_s, cov_s, stats.mu, stats.cov)
            mu_s, sd_s = color_eval.class_color_stats(hsd, gamma)
            return color_eval.image_dist_transform(
                hsd, gamma, mu_s, sd_s, stats.mu, stats.sigma)

        fn = jax.jit(step)
        first = jax.device_put(
            center_tiles(1, args.batch, args.size, args.size, seed=3))
        fn(first, jnp.uint32(0)).block_until_ready()
        tps = chain_tps(jax, fn, first,
                        [(jnp.uint32(i),) for i in range(args.iters + 1)],
                        args.batch)
        results[transfer] = round(tps, 1)
        print(f"{transfer}: {tps:.1f} imgs/sec "
              f"({args.size}x{args.size}, batch {args.batch})", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
