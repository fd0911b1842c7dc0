#!/usr/bin/env python
"""Qualitative samples + invertibility check at REFERENCE capacity.

The reference's ``qualitative_samples.py`` loads a checkpoint and inverts
the flow to draw samples; this driver does the same against a
``train_flow_capacity.py`` checkpoint at the published ~500k-param/256^2
scale: draw latents from the trained GMM mixture, run the fixed-point
``ResidualFlow.inverse`` (40 Banach iterations per block), save a PNG
grid of sampled density channels, and report the forward(inverse(z))
round-trip error — proving invertibility holds at full capacity, not just
at the toy scales the unit tests cover.

    python scripts/sample_flow_capacity.py --ckpt /tmp/flow_capacity/ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", default="/tmp/flow_capacity/ckpt")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--out", default="/tmp/flow_capacity_samples.png")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from stainlib_tpu.data.synthetic import center_tiles
    from stainlib_tpu.models.sampling import sample_flow, save_sample_grid
    from stainlib_tpu.models.train_flow import (
        init_flow_state, reference_capacity)
    from stainlib_tpu.ops.colorspace import rgb_to_hsd
    from stainlib_tpu.utils.checkpoint import restore_checkpoint

    cfg = reference_capacity()
    sample_hsd = np.asarray(rgb_to_hsd(jnp.asarray(
        center_tiles(0, 2, cfg.image_size, cfg.image_size, seed=100))))
    flow, gmm, template, _ = init_flow_state(
        cfg, jax.random.PRNGKey(args.seed), sample_hsd=sample_hsd)
    state = restore_checkpoint(args.ckpt, template)
    print(f"restored step {int(state.step)}", flush=True)

    variables = {"params": state.params["flow"], "spectral": state.spectral}
    gp = state.params["gmm"]
    gmm_params = {"mu": gp["mu"], "sigma": jnp.exp(gp["log_sigma"])}

    x = sample_flow(flow, variables, args.n, jax.random.PRNGKey(args.seed + 1),
                    gmm_params=gmm_params)
    x = jax.block_until_ready(x)
    assert np.isfinite(np.asarray(x)).all()
    save_sample_grid(args.out, np.asarray(x), cols=args.n)
    print(f"wrote {args.out}", flush=True)

    # Invertibility at capacity: forward(inverse(z)) returns z.
    z2, _ = flow.apply(variables, jnp.clip(x, 1e-4, 1.0 - 1e-4),
                       jax.random.PRNGKey(0))
    x2 = flow.apply(variables, z2, method=type(flow).inverse)
    err = float(jnp.max(jnp.abs(jnp.clip(x2, 0, 1) - x)))
    print(json.dumps({"n": args.n, "image_size": cfg.image_size,
                      "roundtrip_max_err": round(err, 6)}), flush=True)
    assert err < 5e-2, err
    return 0


if __name__ == "__main__":
    sys.exit(main())
