#!/usr/bin/env python
"""Train the residual-flow+GMM at the REFERENCE'S published capacity.

The reference's headline artifact is a ~500k-parameter ResidualFlow trained
on 256x256 patches (``dlmodels/color-information/README.md`` "Semantic
Segmentation Comparison": iResFlow 500,388 params; ctor
``train_img_horo.py:324-358`` with ``--idim 128 --kernels 3-1-3``). This
driver proves that configuration end to end ON CHIP:

  * builds ``train_flow.reference_capacity()`` (502,855 params, within
    0.5% of the published count) with per-term logdet remat,
  * trains >= ``--steps`` steps on 256x256 synthetic-cohort HSD patches,
    recording the bits/dim curve (losses stay on device; one fetch at the
    end so no host round trip is charged per step),
  * measures imgs/s over the (inherently dependent) step chain,
  * checkpoints, restores into a fresh state, and trains further,
  * reports NMI SD/CV before vs after recoloring 256^2 eval tiles from
    every synthetic center (>= the 64^2 floor).

    python scripts/train_flow_capacity.py --steps 220 --batch 8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=220,
                   help="TOTAL step target (a resumed run continues up to it)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--resume", action="store_true",
                   help="continue from --out/ckpt's most-recent checkpoint")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every N steps mid-run (0 = end only)")
    p.add_argument("--resume-steps", type=int, default=3)
    p.add_argument("--tiles-per-center", type=int, default=8)
    p.add_argument("--template-tiles", type=int, default=0,
                   help="template pool size (0 = max(4*batch, 32))")
    p.add_argument("--train-centers", default="all",
                   help="comma list of synthetic centers to TRAIN on, or "
                        "'all' (default) / '0'. The reference trains its "
                        "flow on the full multi-lab cohort "
                        "(train_img_horo.py:292-302 loads every center's "
                        "loader); template-only training leaves shifted "
                        "centers out-of-distribution for the GMM "
                        "responsibilities and breaks per-class transfer "
                        "(the seg-transfer mechanism of seg_transfer_demo.py)")
    p.add_argument("--train-pool", type=int, default=0,
                   help="training tiles per center (0 = template pool size)")
    p.add_argument("--cohort", default="bl",
                   choices=("bl", "acquisition", "acquisition-clean"),
                   help="synthetic cohort: 'bl' = Beer-Lambert stain shifts "
                        "(Macenko's own model class — near-oracle for it, "
                        "see seg_transfer_demo.py); 'acquisition' = non-Beer-Lambert "
                        "per-center scanner chains (tone curves, sensor "
                        "saturation, defocus, JPEG) — the inter-lab regime "
                        "the reference claims for the learned flow")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--out", default="/tmp/flow_capacity")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-eval", action="store_true")
    p.add_argument("--ema-val", action="store_true",
                   help="validate with EMA parameters (the reference's "
                        "--ema-val swap, train_img_horo.py:668-669)")
    p.add_argument("--class-match", action="store_true",
                   help="usage-rank class matching at deploy (robust to the "
                        "OOD class permutation, seg_transfer_demo.py); default = "
                        "the reference's k->k mapping")
    p.add_argument("--transfer", default="diag",
                   choices=("diag", "full", "quantile", "rgb-quantile",
                            "full-quantile", "rgb-full-quantile"),
                   help="per-class transfer at deploy: 'diag' = the "
                        "reference's (mu, sigma) affine "
                        "(train_img_horo.py:815); 'full' = full-covariance "
                        "Monge maps; 'quantile'/'rgb-quantile' = per-class "
                        "quantile matching in HSD/RGB; "
                        "'full-quantile'/'rgb-full-quantile' = Monge then "
                        "quantile (all EXTENSIONS; see seg_transfer_demo.py)")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def run(args):
    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from stainlib_tpu.data.synthetic import (
        N_CENTERS, center_tiles, multi_center_batches)
    from stainlib_tpu.models.color_eval import nmi, nmi_sd_cv
    from stainlib_tpu.models.train_flow import (
        init_flow_state, make_train_step, reference_capacity)
    from stainlib_tpu.models.validate_flow import validate
    from stainlib_tpu.ops.colorspace import rgb_to_hsd
    from stainlib_tpu.ops.tissue import tissue_mask
    from stainlib_tpu.utils.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint)

    cfg = reference_capacity()
    s = cfg.image_size
    os.makedirs(args.out, exist_ok=True)

    n_tmpl = args.template_tiles or max(args.batch * 4, 32)
    tmpl_tiles = center_tiles(0, n_tmpl, s, s, seed=args.seed + 100,
                              cohort=args.cohort)
    to_hsd = jax.jit(rgb_to_hsd)
    tmpl_hsd = np.asarray(to_hsd(jnp.asarray(tmpl_tiles)))

    # Training pool: the reference's flow sees the FULL multi-lab cohort
    # (every center's loader feeds training, train_img_horo.py:292-302);
    # the template center is only the transfer TARGET at deploy time.
    if args.train_centers.strip() == "all":
        train_centers = list(range(N_CENTERS))
    else:
        train_centers = [int(c) for c in args.train_centers.split(",")]
    per_center = args.train_pool or n_tmpl
    if train_centers == [0]:
        train_hsd = tmpl_hsd
    else:
        pools = []
        for c in train_centers:
            pools.append(tmpl_tiles if c == 0 else center_tiles(
                c, per_center, s, s, seed=args.seed + 100 + 7 * c,
                cohort=args.cohort))
        train_hsd = np.concatenate(
            [np.asarray(to_hsd(jnp.asarray(t))) for t in pools])
    print(f"training pool: {len(train_hsd)} tiles from centers "
          f"{train_centers}", flush=True)

    flow, gmm, state, tx = init_flow_state(
        cfg, jax.random.PRNGKey(args.seed), sample_hsd=train_hsd[: args.batch]
    )
    n_params = sum(int(np.prod(p.shape))
                   for p in jax.tree.leaves(state.params))
    print(f"params: {n_params} (reference published 500,388)", flush=True)

    step_fn = make_train_step(flow, gmm, cfg, tx)
    rng = np.random.default_rng(args.seed)

    def batch_at(i):
        sel = rng.integers(0, len(train_hsd), args.batch)
        return jnp.asarray(train_hsd[sel])

    ckdir = os.path.join(args.out, "ckpt")
    start = 0
    if args.resume:
        prev = latest_step(ckdir)
        if prev is None:
            print(f"--resume: no checkpoint under {ckdir}; starting fresh",
                  flush=True)
        else:
            state = restore_checkpoint(ckdir, state)
            start = int(state.step)
            print(f"resumed from step {start}", flush=True)
    if start >= args.steps:
        raise SystemExit(
            f"checkpoint already at step {start} >= --steps {args.steps}")

    # Warmup/compile on the first step; then time the dependent chain.
    t_compile = time.perf_counter()
    state, loss0 = step_fn(state, batch_at(start))
    print(f"first step (compile) {time.perf_counter() - t_compile:.1f}s "
          f"bpd {float(loss0):.4f}", flush=True)

    losses = [loss0]
    t0 = time.perf_counter()
    for i in range(start + 1, args.steps):
        state, loss = step_fn(state, batch_at(i))
        losses.append(loss)  # stays on device; the state chain is dependent
        if args.save_every and (i + 1) % args.save_every == 0:
            # device_get drains the chain; amortized over save_every steps.
            save_checkpoint(ckdir, jax.tree.map(np.asarray, state), i + 1)
            print(f"step {i + 1}: bpd {float(loss):.4f} (checkpointed)",
                  flush=True)
    final_bpd = float(losses[-1])  # single fetch drains the whole chain
    n_timed = max(args.steps - start - 1, 1)
    dt = time.perf_counter() - t0
    imgs_s = n_timed * args.batch / dt
    curve = [round(float(l), 4) for l in losses[:: args.log_every]]
    print(f"steps {start + 1}..{args.steps - 1}: {dt:.1f}s = "
          f"{imgs_s:.1f} imgs/s ({dt / n_timed * 1e3:.0f} ms/step)",
          flush=True)
    print(f"bpd curve (every {args.log_every}): {curve}", flush=True)
    print(f"final bpd {final_bpd:.4f}", flush=True)
    assert np.isfinite(final_bpd), "bpd diverged"

    # Checkpoint + resume at full capacity (train_img_horo.py:421-448,
    # 1149-1165 parity via utils/checkpoint.py).
    save_checkpoint(ckdir, jax.tree.map(np.asarray, state), args.steps)
    _, _, fresh, _ = init_flow_state(
        cfg, jax.random.PRNGKey(args.seed + 7),
        sample_hsd=tmpl_hsd[: args.batch],
    )
    restored = restore_checkpoint(ckdir, fresh)
    assert int(restored.step) == int(state.step)
    r_losses = []
    for i in range(args.resume_steps):
        restored, rl = step_fn(restored, batch_at(10_000 + i))
        r_losses.append(rl)
    resumed_bpd = float(r_losses[-1])
    print(f"resume: {args.resume_steps} further steps, bpd {resumed_bpd:.4f}",
          flush=True)
    assert np.isfinite(resumed_bpd)

    summary = {
        "cohort": args.cohort,
        "params": n_params, "image_size": s, "batch": args.batch,
        "steps": args.steps, "imgs_per_s": round(imgs_s, 1),
        "ms_per_step": round(dt / (args.steps - 1) * 1e3, 1),
        "bpd_first": round(float(loss0), 4), "bpd_final": round(final_bpd, 4),
        "bpd_resumed": round(resumed_bpd, 4), "bpd_curve": curve,
    }

    if not args.skip_eval:
        # NMI before/after at full 256^2 eval tiles over every center.
        test_rgb, _ = multi_center_batches(
            range(N_CENTERS), args.tiles_per_center, args.batch, s, s,
            seed=args.seed + 200, cohort=args.cohort)
        raw = []
        for b in test_rgb:
            masks = np.asarray(tissue_mask(jnp.asarray(b)).mask)
            raw += [float(nmi(b[i], masks[i])) for i in range(b.shape[0])]
        raw_sd, raw_cv = nmi_sd_cv(raw)
        test_hsd = [np.asarray(to_hsd(jnp.asarray(b))) for b in test_rgb]
        eval_params = (restored.ema.params if args.ema_val
                       else restored.params)
        res = validate(
            flow, gmm, cfg, eval_params, restored.spectral,
            [tmpl_hsd[i: i + args.batch]
             for i in range(0, n_tmpl, args.batch)],
            test_hsd, jax.random.PRNGKey(args.seed + 1), out_dir=args.out,
            class_match=args.class_match, transfer=args.transfer)
        summary.update({
            "raw_nmi_sd": round(raw_sd, 4), "raw_nmi_cv": round(raw_cv, 4),
            "normalized_nmi_sd": round(res["nmi_sd"], 4),
            "normalized_nmi_cv": round(res["nmi_cv"], 4),
            "sd_reduction": round(raw_sd / max(res["nmi_sd"], 1e-9), 2),
            # The reference's exact statistic (per-class SD/CV averaged
            # across classes, train_img_horo.py:865-898), before/after.
            "class_nmi_sd_raw": round(res["class_nmi_sd_raw"], 4),
            "class_nmi_cv_raw": round(res["class_nmi_cv_raw"], 4),
            "class_nmi_sd": round(res["class_nmi_sd"], 4),
            "class_nmi_cv": round(res["class_nmi_cv"], 4),
        })

    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "capacity_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
