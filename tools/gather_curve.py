#!/usr/bin/env python
"""Measure the device's random-row-gather rate vs table size AND index shape.

The size curve bears on the fp engine's table layout and on the Bloom
pre-filter cap (db/fpdb.BLOOM_MAX_BLOCKS): the filter pays only while one
gather into it is cheaper than the L1/L2 gathers it saves.  On the H100 the
interesting break is the 50 MB L2 cache (not measured yet).

``--shapes`` times the same lane count laid out as different index shapes
([8192, K], flat, [odd, 128], ...).

    python tools/gather_curve.py [--sizes-mb 2 8 16 33 67 134 268 536 1072]
    python tools/gather_curve.py --shapes
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _shape_experiment(iters: int) -> None:
    import jax
    import jax.numpy as jnp

    tab = jax.device_put(
        np.arange(8388608 * 4, dtype=np.uint32).reshape(8388608, 4)
    )
    out = {}
    for shape in [(8192, 131), (8385, 128), (8192, 128), (8384, 128),
                  (4191, 256), (2095, 512), (1047, 1024), (16766, 64),
                  (8192, 12), (769, 128), (768, 128), (513, 128),
                  (512, 128)]:
        idx = jnp.asarray(
            np.random.default_rng(1).integers(
                0, tab.shape[0], size=shape
            ).astype(np.int32)
        )

        @jax.jit
        def run(t, ix, iters):
            def step(i, acc):
                r = jnp.take(t, (ix + i) % t.shape[0], axis=0)
                return acc + r[..., 0].sum()

            return jax.lax.fori_loop(0, iters, step, jnp.uint32(0))

        run(tab, idx, 2).block_until_ready()
        t0 = time.time()
        run(tab, idx, iters).block_until_ready()
        dt = (time.time() - t0) / iters * 1e3
        n = int(np.prod(shape))
        v2 = (n & -n).bit_length() - 1  # 2-adic valuation of the lane count
        out[str(shape)] = round(dt, 3)
        print(f"[gather] {str(shape):14s} n={n:8d} 2^{v2:<2d} {dt:8.3f} ms",
              file=sys.stderr, flush=True)
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes-mb", type=int, nargs="+",
                    default=[2, 8, 16, 33, 67, 134, 268, 536, 1072])
    ap.add_argument("--queries", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--row-bytes", type=int, default=16,
                    help="gather row width (16 = the fp tables' format)")
    ap.add_argument("--shapes", action="store_true",
                    help="index-shape experiment at fixed lane counts")
    args = ap.parse_args()
    if args.shapes:
        return _shape_experiment(args.iters * 4)

    import jax
    import jax.numpy as jnp

    q = args.queries
    w = args.row_bytes // 4
    out = {}
    for mb in args.sizes_mb:
        rows = mb * (1 << 20) // args.row_bytes
        # host-built table shipped with device_put
        tab = jax.device_put(
            np.arange(rows * w, dtype=np.uint32).reshape(rows, w)
        )
        # index shape [B, P] mimics the engine's per-window gather plane
        idx = jnp.asarray(
            np.random.default_rng(1)
            .integers(0, rows, size=q, dtype=np.int64)
            .reshape(8192, -1)
        ).astype(jnp.int32)

        @jax.jit
        def run(t, ix, iters):
            def step(i, acc):
                r = jnp.take(t, (ix + i) % rows, axis=0)
                return acc + r[..., 0].sum()

            return jax.lax.fori_loop(0, iters, step, jnp.uint32(0))

        run(tab, idx, 2).block_until_ready()  # compile + warm
        t0 = time.time()
        run(tab, idx, args.iters).block_until_ready()
        dt = (time.time() - t0) / args.iters
        rate = q / dt / 1e6
        out[f"{mb}MB"] = round(rate, 1)
        print(f"[gather] {mb:5d} MB: {rate:8.1f} M rows/s "
              f"({dt * 1e3:.2f} ms / {q >> 20}M gathers)", file=sys.stderr,
              flush=True)
        del tab
    print(json.dumps(out))


if __name__ == "__main__":
    main()
