#!/usr/bin/env python
"""Host-side slide-decode throughput and its thread-count scaling.

Measures the C++ libtiff reader (``tiffreader.cpp``) on a synthetic
.svs-layout JPEG slide: random rejection sampling (``tf_sample_tiles``, the
train path) and batched grid decode (``tf_read_regions``, the eval path) at
STAINLIB_TIFF_THREADS in {1, 2, 4, 8}. On a host with many cores the
streaming pipeline is bounded by min(host decode x cores, device rate); this
table gives the per-core number and the thread-scaling behavior (on a
single-core host, flat-at-1x proves the handle pool adds no contention
penalty; real scaling needs real cores).

    python scripts/bench_host_ingestion.py --size 4096 --tile 256
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stainlib_tpu.data import native  # noqa: E402


def make_slide(path: str, size: int, tile: int, quality: int = 85) -> None:
    rng = np.random.default_rng(0)
    base = rng.integers(60, 220, (size // 64, size // 64, 3)).astype(np.uint8)
    lv0 = np.kron(base, np.ones((64, 64, 1), np.uint8))  # smooth-ish content
    lv1 = lv0[::4, ::4].copy()
    native.write_tiff_pyramid(path, [lv0, lv1], tile=tile,
                              compression="jpeg", quality=quality)


def bench(slide: "native.TiffSlide", tile: int, n: int, threads: int):
    os.environ["STAINLIB_TIFF_THREADS"] = str(threads)
    W, H = slide.level_size(0)
    # Random sampling (train path).
    t0 = time.perf_counter()
    tiles, _ = slide.sample_tiles(0, tile, n, seed=7, white_mean_max=255.0,
                                  stddev_min=0.0)
    dt_sample = time.perf_counter() - t0
    assert tiles.shape == (n, tile, tile, 3)
    # Batched grid decode (eval path).
    rng = np.random.default_rng(1)
    coords = np.stack([
        rng.integers(0, W - tile, n), rng.integers(0, H - tile, n)
    ], -1).astype(np.int64)
    t0 = time.perf_counter()
    out = slide.read_regions(0, coords, tile, tile)
    dt_eval = time.perf_counter() - t0
    assert out.shape == (n, tile, tile, 3)
    return n / dt_sample, n / dt_eval


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--threads", default="1,2,4,8")
    args = ap.parse_args(argv)

    if not native.tiff_native_available():
        print(json.dumps({"error": "libtiff toolchain missing"}))
        return 1

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench.svs")
        make_slide(path, args.size, args.tile)
        slide = native.TiffSlide(path)
        rows = {}
        try:
            bench(slide, args.tile, 16, 1)  # warm the codec/pool
            for th in [int(t) for t in args.threads.split(",")]:
                s_tps, e_tps = bench(slide, args.tile, args.n, th)
                rows[th] = {"sample_tiles_tps": round(s_tps, 1),
                            "read_regions_tps": round(e_tps, 1)}
                print(f"threads={th}: sample {s_tps:.0f} tiles/s, "
                      f"eval-batch {e_tps:.0f} tiles/s", flush=True)
        finally:
            slide.close()
            os.environ.pop("STAINLIB_TIFF_THREADS", None)
    print(json.dumps({"host_cores": os.cpu_count(), "tile": args.tile,
                      "jpeg_size": args.size, "by_threads": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
