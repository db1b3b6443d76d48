"""tools/finals_ab.py at a tiny size on the CPU: both gather layouts give the
same finals and seen, ucount matches np.bincount, and the trace reader
takes the union of the device's kernel intervals."""

import gzip
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import finals_ab  # noqa: E402


def test_finals_ab_tiny():
    out = finals_ab.run(n_probes=20_000, num_targ=64, n_orgs=100, batch=128,
                        max_len=160, iters=2, rounds=2, seed=3)
    assert set(out["finals_ms"]) == {"odd128", "plain"}
    assert all(len(v) == 2 and min(v) > 0 for v in out["finals_ms"].values())
    assert out["finals_nonzero"] > 50  # the batch really classifies
    assert len(out["ucount_ms"]) == 2


def test_busy_ms_unions_device_intervals(tmp_path):
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "tid": 7, "ts": 0, "dur": 100},
        {"ph": "X", "pid": 1, "tid": 8, "ts": 50, "dur": 100},  # overlaps
        {"ph": "X", "pid": 1, "tid": 7, "ts": 400, "dur": 100},
        {"ph": "X", "pid": 2, "tid": 1, "ts": 0, "dur": 10_000},  # host
    ]
    with gzip.open(d / "vm.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    # (150 + 100) us over 2 calls
    assert finals_ab.busy_ms(str(tmp_path), 2) == 0.125
