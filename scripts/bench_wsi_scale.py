#!/usr/bin/env python
"""Reference-scale whole-slide drive: >=20k tiles (>2 GB level-0) end to end.

The reference's ``tester`` deployment iterates 100k+ patches per slide
(``dlmodels/color-information/data_utils.py:1``); this driver proves the
memmap-canvas deployment story at that scale in anger, not just in the
unit-tested branch: generate a synthetic H&E .svs whose level-0 exceeds the
RAM-canvas threshold, push it through ``normalize_slide`` (threaded decode
-> prefetch ring -> jitted fixed-matrix apply -> pyramidal TIFF), and
report wall time, steady-state tiles/s, and peak RSS.

    python scripts/bench_wsi_scale.py --side 36864   # 144x144 = 20,736 tiles
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--side", type=int, default=36864,
                   help="level-0 side in px (36864 -> 20,736 256-tiles, "
                        "4.1 GB raw)")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--method", default="macenko")
    p.add_argument("--estimation", default="slide")
    p.add_argument("--workdir", default="/tmp/wsi_scale")
    p.add_argument("--keep", action="store_true",
                   help="keep the generated input/output slides")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def synth_level0(side: int, tile: int, seed: int):
    """A side x side H&E-like field written in tile rows (bounded temps):
    smooth sinusoidal concentration fields + noise, white margin band."""
    import numpy as np

    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    lv0 = np.empty((side, side, 3), np.uint8)
    xs = np.arange(side, dtype=np.float32)
    for r0 in range(0, side, tile):
        r1 = min(r0 + tile, side)
        yy = np.arange(r0, r1, dtype=np.float32)[:, None]
        c_h = np.clip(0.8 + 0.6 * np.sin(yy / 9.0) * np.cos(xs / 7.0),
                      0, None)
        c_e = np.clip(0.6 + 0.4 * np.cos(yy / 11.0) * np.sin(xs / 5.0),
                      0, None)
        C = np.stack([c_h, c_e], -1).astype(np.float32)
        C *= 0.9 + 0.2 * rng.random((r1 - r0, side, 2), np.float32)
        img = 255.0 * np.exp(-(C @ he.astype(np.float32)))
        lv0[r0:r1] = np.clip(img, 0, 255).astype(np.uint8)
    # White margin (background rejection + partial-tile handling).
    m = tile // 2
    lv0[:m] = 255
    lv0[:, :m] = 255
    return lv0


def run(args):
    import numpy as np

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from stainlib_tpu.data.native import write_tiff_pyramid
    from stainlib_tpu.normalization.slide import normalize_slide

    os.makedirs(args.workdir, exist_ok=True)
    src = os.path.join(args.workdir, "scale_in.svs")
    out = os.path.join(args.workdir, "scale_out.tif")

    t_gen = time.time()
    if not os.path.exists(src):
        lv0 = synth_level0(args.side, args.tile, args.seed)
        gb = lv0.nbytes / 2**30
        print(f"generated level-0 {args.side}^2 ({gb:.2f} GB raw) "
              f"in {time.time() - t_gen:.0f}s", flush=True)
        write_tiff_pyramid(src, [lv0], tile=args.tile, compression="jpeg")
        del lv0
        print(f"wrote {src} ({os.path.getsize(src) / 2**30:.2f} GB) "
              f"in {time.time() - t_gen:.0f}s total", flush=True)

    marks = []  # (batch_index, t) from the progress callback

    def progress(done, total):
        marks.append((done, time.time()))
        if done % 20 == 0 or done == total:
            print(f"  {done}/{total} batches", flush=True)

    t0 = time.time()
    info = normalize_slide(src, out, _target(),
                           method=args.method, estimation=args.estimation,
                           tile=args.tile, batch=args.batch,
                           progress=progress)
    wall = time.time() - t0
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20

    # Steady-state rate: drop the first 10% of batches (compile +
    # warm-up), slope over the rest. Degenerate for tiny smokes (< 3
    # batches): fall back to the end-to-end rate.
    n = len(marks)
    k = max(1, n // 10)
    (b0, s0), (b1, s1) = marks[k - 1], marks[-1]
    steady = ((b1 - b0) * args.batch / max(s1 - s0, 1e-9)
              if b1 > b0 else info["tiles"] / wall)

    summary = {
        "side": args.side, "tiles": info["tiles"],
        "level0_gb": round(args.side * args.side * 3 / 2**30, 2),
        "estimation": info["estimation"],
        "wall_s": round(wall, 1),
        "tiles_per_s_end_to_end": round(info["tiles"] / wall, 1),
        "tiles_per_s_steady": round(steady, 1),
        "peak_rss_gb": round(peak_rss_gb, 2),
        "out_gb": round(os.path.getsize(out) / 2**30, 2),
    }
    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.workdir, "wsi_scale.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if not args.keep:
        os.remove(src)
        os.remove(out)
    return summary


def _target():
    import numpy as np

    stain = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
    stain = stain / np.linalg.norm(stain, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    c_h = 0.9 + 0.5 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    c_e = 0.7 + 0.3 * np.cos(yy / 11.0) * np.sin(xx / 7.0)
    C = np.clip(np.stack([c_h, c_e], -1), 0, None)
    img = 255.0 * np.exp(-(C @ stain))
    return np.clip(img, 0, 255).astype(np.uint8)


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
