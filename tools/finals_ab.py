#!/usr/bin/env python
"""Gather-layout A/B of the finals step, and the ucount finalize, at the
smoke's scale.

    python tools/finals_ab.py [--iters 200] [--trace DIR]

Builds chip_smoke.py's bact10-shaped DB (33,000,000 probes) and
times the finals step (``_fp_finals_packed`` at B = 8192, L = 160; 60% of
the reads carry 1-3 probes of one target, 10% two random probes) with two
formulations of its narrow row gathers:

- ``odd128``: ``ops.lookup.take_rows`` as shipped (the [odd, 128] layout);
- ``plain``: ``jnp.take(tab, idx, axis=0)``.

Each of two rounds times every variant once, in the order A B B A: ``--iters``
calls chained through the donated ``seen`` bitmap, ending in
``block_until_ready``, on the host clock.  Both variants must give the same
finals and ``seen``.  With ``--trace DIR`` a 20-call ``jax.profiler`` trace
per variant gives the device's busy ms per call (the union of its kernel
intervals).  Then it times ``_ucount_device`` over every slot and checks it
against ``np.bincount``.  The last stdout line is one JSON object.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

MAX_HITS = 32
TRACE_CALLS = 20


def say(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


def make_batch(db: dict, batch: int, max_len: int, seed: int):
    """Packed [batch, max_len] reads with planted probes of the DB."""
    from kmer_id_tpu.io.batch import pack_codes

    rng = np.random.default_rng(seed)
    keys, targets = db["keys"], db["targets"]
    shifts = np.array([2 * (29 - j) for j in range(30)], dtype=np.uint64)
    pick = rng.choice(len(keys), size=min(len(keys), 50_000), replace=False)
    pcodes = ((keys[pick][:, None] >> shifts) & np.uint64(3)).astype(np.uint8)
    order = np.argsort(targets[pick], kind="stable")
    _, start, count = np.unique(targets[pick][order], return_index=True,
                                return_counts=True)
    codes = rng.integers(0, 4, size=(batch, max_len), dtype=np.uint8)
    kind = rng.random(batch)
    for row in range(batch):
        if kind[row] < 0.6:  # 1-3 probes of one target
            t = rng.integers(len(start))
            chosen = order[start[t] + rng.integers(0, count[t],
                                                   size=rng.integers(1, 4))]
        elif kind[row] < 0.7:  # two random probes
            chosen = rng.integers(0, len(pick), size=2)
        else:
            continue
        for p in chosen:
            pos = int(rng.integers(0, max_len - 30))
            codes[row, pos:pos + 30] = pcodes[p]
    lengths = np.full(batch, max_len, np.int32)
    packed, exc = pack_codes(codes, lengths)
    return packed, exc, lengths


def plain_take(tab, idx):
    import jax.numpy as jnp

    return jnp.take(tab, idx, axis=0)


def compile_finals(dbd, batch, seen, gather, max_len: int):
    """``_fp_finals_packed`` compiled with ``gather`` in place of
    ``take_rows`` (read from ``ops.lookup`` at trace time).  Each call wraps
    the step in a new function: JAX caches traces by function, and a second
    jit of the same function would reuse the first variant's trace."""
    import jax

    from kmer_id_tpu.engine import fpclassify as F
    from kmer_id_tpu.ops import lookup

    def step(*args, **kw):
        return F._fp_finals_packed.__wrapped__(*args, **kw)

    fn = jax.jit(step, static_argnames=("l", "max_hits"), donate_argnums=(4,))
    shipped = lookup.take_rows
    lookup.take_rows = gather
    try:
        return fn.lower(dbd, *batch, seen, l=max_len, max_hits=MAX_HITS).compile()
    finally:
        lookup.take_rows = shipped


def run_calls(step, dbd, batch, seen, n: int):
    import jax

    finals = None
    for _ in range(n):
        finals, seen = step(dbd, *batch, seen)
    jax.block_until_ready((finals, seen))
    return finals, seen


def busy_ms(trace_dir: str, calls: int) -> float | None:
    """Device busy ms per call: the union of the device's kernel intervals
    in the newest trace under ``trace_dir``; None without a device lane."""
    newest = max(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                        "*.trace.json.gz")), key=os.path.getmtime)
    with gzip.open(newest) as f:
        events = json.load(f)["traceEvents"]
    dev = {e["pid"] for e in events if e.get("ph") == "M"
           and e.get("name") == "process_name"
           and e["args"]["name"].startswith("/device:")}
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e["pid"] in dev)
    if not spans:
        return None
    total, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / calls / 1e3


def run(n_probes: int = chip_smoke.N_PROBES, num_targ: int = chip_smoke.NUM_TARG,
        n_orgs: int = chip_smoke.N_ORGS, batch: int = chip_smoke.BATCH,
        max_len: int = chip_smoke.MAX_LEN, iters: int = 200, rounds: int = 2,
        trace: str | None = None, seed: int = chip_smoke.SEED) -> dict:
    import jax
    import jax.numpy as jnp

    from kmer_id_tpu.core.taxonomy import Taxonomy
    from kmer_id_tpu.db.fpdb import load_fpdb
    from kmer_id_tpu.engine import fpclassify as F
    from kmer_id_tpu.ops.lookup import take_rows

    with tempfile.TemporaryDirectory(prefix="kmer_ab_") as work:
        db = chip_smoke.make_db(work, n_probes=n_probes, num_targ=num_targ,
                                n_orgs=n_orgs, seed=seed)
        fp = load_fpdb(db["cache"])
    parent = db["parent"]
    tax = Taxonomy.from_edges([(int(parent[t]), t) for t in range(2, num_targ)],
                              num_nodes=num_targ)
    dbd = {k: jnp.asarray(v) for k, v in F.device_tables(fp, tax).items()}
    host_batch = make_batch(db, batch, max_len, seed)
    dev_batch = tuple(jnp.asarray(a) for a in host_batch)

    def zeros():
        return jnp.zeros((fp.n_slots,), jnp.int8)

    variants = {"odd128": take_rows, "plain": plain_take}
    steps, outs = {}, {}
    for name, gather in variants.items():
        t0 = time.perf_counter()
        steps[name] = compile_finals(dbd, dev_batch, zeros(), gather, max_len)
        finals, seen = run_calls(steps[name], dbd, dev_batch, zeros(), 1)
        outs[name] = (np.asarray(finals), np.asarray(seen))
        say(f"{name}: compile + first call {time.perf_counter() - t0:.1f} s")
    if steps["odd128"].as_text() == steps["plain"].as_text():
        raise SystemExit("both variants compiled to the same program")
    base = outs["odd128"]
    equal = all(np.array_equal(o[0], base[0]) and np.array_equal(o[1], base[1])
                for o in outs.values())
    say(f"finals and seen equal across variants: {equal}")
    if not equal:
        raise SystemExit("the gather variants disagree")

    ms = {name: [] for name in variants}
    order = list(variants)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            run_calls(steps[name], dbd, dev_batch, zeros(), 1)  # warm
            seen = zeros().block_until_ready()
            t0 = time.perf_counter()
            run_calls(steps[name], dbd, dev_batch, seen, iters)
            ms[name].append((time.perf_counter() - t0) / iters * 1e3)
            say(f"finals B={batch} L={max_len} [{name}]: {ms[name][-1]:.4f} ms/call")

    busy = {}
    if trace:
        for name in variants:
            d = os.path.join(trace, name)
            jax.profiler.start_trace(d)
            run_calls(steps[name], dbd, dev_batch, zeros(), TRACE_CALLS)
            jax.profiler.stop_trace()
            busy[name] = busy_ms(d, TRACE_CALLS)
            say(f"device busy [{name}]: {busy[name]} ms/call")

    node = F._slot_nodes(dbd["rec"], dbd["tinfo"])
    seen = jnp.asarray(base[1])
    got = np.asarray(F._ucount_device(seen, node, num_targ=num_targ))
    nd, sn = np.asarray(node), base[1]
    want = np.bincount(nd[(sn > 0) & (nd > 1)], minlength=num_targ)
    if not np.array_equal(got, want):
        raise SystemExit("ucount disagrees with np.bincount")
    ucount_ms = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = F._ucount_device(seen, node, num_targ=num_targ)
        out.block_until_ready()
        ucount_ms.append((time.perf_counter() - t0) / iters * 1e3)
    say(f"ucount over {fp.n_slots} slots ({int((sn > 0).sum())} set): "
        f"{ucount_ms} ms/call, equal to np.bincount")
    return {"probes": int(n_probes), "slots": int(fp.n_slots),
            "finals_nonzero": int((base[0] != 0).sum()), "finals_ms": ms,
            "device_busy_ms": busy, "ucount_ms": ucount_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--trace", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    import jax

    from kmer_id_tpu.utils.device import device_summary, setup_compile_cache

    setup_compile_cache()
    dev = device_summary()
    card = chip_smoke.gpu_line() if dev["platform"] == "gpu" else "not a GPU"
    say(f"card: {card}; jax {jax.__version__}: {dev}")
    out = run(iters=args.iters, trace=args.trace)
    print(json.dumps({"device": dev, "card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
