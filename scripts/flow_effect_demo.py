#!/usr/bin/env python
"""Demonstrate that the flow+GMM normalizer actually normalizes.

The reference's headline result is the drop in NMI SD/CV after flow-based
color normalization (``dlmodels/color-information/README.md`` NMI tables;
machinery ``train_img_horo.py:658-930``). CAMELYON17 is absent here, so this
driver uses the synthetic multi-center cohort
(``stainlib_tpu/data/synthetic.py``) whose raw inter-center NMI spread is
~4x the published normalized level, trains the flow+GMM on the template
center, and reports NMI SD/CV BEFORE vs AFTER ``image_dist_transform``.

    python scripts/flow_effect_demo.py --steps 300 --out /tmp/flow_effect
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--tiles-per-center", type=int, default=16)
    p.add_argument("--n-scales", type=int, default=2)
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--clusters", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--out", default="/tmp/flow_effect")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
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
        N_CENTERS, center_tiles, multi_center_batches,
    )
    from stainlib_tpu.models.color_eval import nmi, nmi_sd_cv
    from stainlib_tpu.models.train_flow import (
        FlowConfig, init_flow_state, make_train_step,
    )
    from stainlib_tpu.models.validate_flow import validate
    from stainlib_tpu.ops.colorspace import rgb_to_hsd
    from stainlib_tpu.ops.tissue import tissue_mask

    s = args.image_size
    # Template loader: the template center only (center 0, the reference's
    # RadboudUMC role); test loader: every center.
    tmpl_tiles = center_tiles(0, args.batch * 2, s, s, seed=args.seed + 100)
    test_batches_rgb, _ = multi_center_batches(
        range(N_CENTERS), args.tiles_per_center, args.batch, s, s,
        seed=args.seed + 200,
    )

    # Raw (un-normalized) NMI spread — the "before" column.
    raw_nmis = []
    for b in test_batches_rgb:
        masks = np.asarray(tissue_mask(jnp.asarray(b)).mask)
        raw_nmis += [float(nmi(b[i], masks[i])) for i in range(b.shape[0])]
    raw_sd, raw_cv = nmi_sd_cv(raw_nmis)

    # Train the flow+GMM on the template center.
    cfg = FlowConfig(image_size=s, n_scales=args.n_scales,
                     blocks_per_scale=args.blocks, hidden=args.hidden,
                     n_clusters=args.clusters, lr=args.lr,
                     warmup_iters=min(100, args.steps // 3))
    to_hsd = jax.jit(lambda b: rgb_to_hsd(b))
    tmpl_hsd = np.asarray(to_hsd(jnp.asarray(tmpl_tiles)))
    flow, gmm, state, tx = init_flow_state(
        cfg, jax.random.PRNGKey(args.seed), sample_hsd=tmpl_hsd[: args.batch]
    )
    step_fn = make_train_step(flow, gmm, cfg, tx)
    rng = np.random.default_rng(args.seed)
    for i in range(args.steps):
        sel = rng.integers(0, len(tmpl_tiles), args.batch)
        state, loss = step_fn(state, jnp.asarray(tmpl_hsd[sel]))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: bpd {float(loss):.4f}", flush=True)

    # Validate: template stats -> recolor every test batch -> NMI SD/CV.
    test_batches_hsd = [np.asarray(to_hsd(jnp.asarray(b)))
                        for b in test_batches_rgb]
    res = validate(
        flow, gmm, cfg, state.params, state.spectral,
        [tmpl_hsd[i : i + args.batch]
         for i in range(0, len(tmpl_hsd), args.batch)],
        test_batches_hsd, jax.random.PRNGKey(args.seed + 1),
        out_dir=args.out,
    )

    summary = {
        "raw_nmi_sd": round(raw_sd, 4), "raw_nmi_cv": round(raw_cv, 4),
        "normalized_nmi_sd": round(res["nmi_sd"], 4),
        "normalized_nmi_cv": round(res["nmi_cv"], 4),
        "sd_reduction": round(raw_sd / max(res["nmi_sd"], 1e-9), 2),
        "cv_reduction": round(raw_cv / max(res["nmi_cv"], 1e-9), 2),
        "n_images": len(res["nmi"]), "steps": args.steps,
    }
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "effect_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
